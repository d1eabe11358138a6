"""HDR environment light with 2-stage CDF importance sampling.

Mirrors reference src/scene/environment_light.cpp:
  - build: pixel pdf = luminance * sin(pi (j+.5)/h), marginal CDF over rows,
    conditional CDF over columns (environment_light.cpp:18-62)
  - sample_dir: equirectangular lookup with the reference's robust bilerp
    (environment_light.cpp:114-180); direction convention
    theta = acos(y), phi = atan2(-z, x) + pi (environment_light.cpp:100-112)
  - sample_L: 2-stage CDF inversion with the Jacobian pdf
    p(w) = p(x,y) * (w*h) / (2 pi^2 sin(theta))  (environment_light.cpp:138-169)

Used by the unidirectional tracer for NEE and primary-miss shading, and —
EXTENSION beyond the reference, whose BDPT asserts on env lights
(environment_light.cpp:182-208) — by the BDPT integrator, which renders
env-lit scenes with the same strategy family (primary-miss radiance + env
NEE per non-delta eye vertex; models/bdpt.py, tests/test_env_bdpt.py).
Light subpaths never start on the envmap, so its sample_Le-side methods
remain absent by design.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bidirectional_pathtracing.core.math import INF_D, PI, normalize
from bidirectional_pathtracing.scene.types import Envmap

_LUMA = np.array([0.2126, 0.7152, 0.0722])


def build_envmap(data: np.ndarray) -> Envmap:
    """data: [H,W,3] float.  Precomputes pdf + CDF tables on host."""
    data = np.asarray(data, np.float64)
    h, w = data.shape[:2]
    lum = data @ _LUMA
    pdf = lum * np.sin(PI * (np.arange(h)[:, None] + 0.5) / h)
    pdf = pdf / pdf.sum()
    row_p = pdf.sum(axis=1)
    marginal_cdf = np.cumsum(row_p)
    conds = np.cumsum(pdf / np.maximum(row_p[:, None], 1e-30), axis=1)
    return Envmap(
        data=jnp.asarray(data, jnp.float32),
        pdf=jnp.asarray(pdf, jnp.float32),
        marginal_cdf=jnp.asarray(marginal_cdf, jnp.float32),
        conditional_cdf=jnp.asarray(conds, jnp.float32),
    )


def save_probability_debug(env: Envmap, path: str = "probability_debug.png"):
    """EnvironmentLight::save_probability_debug (environment_light.cpp:66-81):
    per-pixel debug PNG with R = marginal row CDF, G = conditional column
    CDF, B = 0, alpha = 255."""
    from bidirectional_pathtracing.utils.png import write_png
    m = np.asarray(env.marginal_cdf, np.float64)
    c = np.asarray(env.conditional_cdf, np.float64)
    h, w = c.shape
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 0] = np.clip(255.0 * m[:, None], 0, 255).astype(np.uint8)
    img[..., 1] = np.clip(255.0 * c, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    write_png(path, img)


def _dir_to_xy(d, w, h):
    """dir -> continuous (x, y) pixel coords (environment_light.cpp:84-105)."""
    u = normalize(d)
    theta = jnp.arccos(jnp.clip(u[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(-u[..., 2], u[..., 0]) + PI
    return phi / (2.0 * PI) * w, theta / PI * h


def _bilerp(env: Envmap, x, y):
    """The reference's wrap-aware bilerp (environment_light.cpp:119-135)."""
    h, w = env.data.shape[:2]
    right = jnp.round(x).astype(jnp.int32)
    v = jnp.round(y).astype(jnp.int32)
    u1 = right.astype(jnp.float32) - x + 0.5
    wrap = (right == 0) | (right == w)
    left = jnp.where(wrap, w - 1, right - 1)
    right = jnp.where(wrap, 0, right)
    v1 = jnp.where(v == 0, 1.0,
                   jnp.where(v == h, 0.0, v.astype(jnp.float32) - y + 0.5))
    v = jnp.clip(jnp.where(v == 0, 1, jnp.where(v == h, h - 1, v)), 1, h - 1)
    top = v - 1
    u0 = 1.0 - u1
    d = env.data
    val = ((d[top, left] * u1[..., None] + d[top, right] * u0[..., None])
           * v1[..., None]
           + (d[v, left] * u1[..., None] + d[v, right] * u0[..., None])
           * (1.0 - v1)[..., None])
    return val


def sample_dir(env: Envmap, d):
    """Radiance along direction d (primary-miss shading;
    environment_light.cpp:171-180)."""
    h, w = env.data.shape[:2]
    x, y = _dir_to_xy(d, w, h)
    return _bilerp(env, x, y)


def sample_Le(env: Envmap, center, radius, u4, u2):
    """Emit a light ray FROM the environment (pbrt-style infinite-light
    emission; EXTENSION — the reference asserts on every BDPT method of
    its EnvironmentLight, environment_light.cpp:182-208).

    direction: 2-stage CDF importance sample w (pointing TOWARD the env,
    like sample_L); the ray travels d = -w into the scene.
    origin: uniform point on the disk of the scene bounding sphere
    (`center`, `radius`), perpendicular to w, pushed out by 2*radius so
    the ray sweeps the whole scene.
    Returns (radiance, o, d, point_pdf, dir_pdf):
      point_pdf = 1/(pi r^2)   [area measure on the disk]
      dir_pdf   = CDF pdf      [solid angle]

    Feeds BDPT strategy family (c): emission subpaths splatted to the
    camera, MIS-weighted against the eye-side env strategies (env NEE and
    eye-walk-miss pickup) of each path class — models/bdpt.py
    _env_subpath_splats, tests/test_env_bdpt.py.
    """
    rad, w_dir, _dist, dir_pdf = sample_L(env, center, u4)
    # orthonormal frame around w
    from bidirectional_pathtracing.core.math import make_coord_space
    frame = make_coord_space(w_dir)
    r_sq = jnp.sqrt(u2[..., 0])
    phi = 2.0 * PI * u2[..., 1]
    ox = radius * r_sq * jnp.cos(phi)
    oy = radius * r_sq * jnp.sin(phi)
    o = (center + w_dir * (2.0 * radius)
         + frame[..., :, 0] * ox[..., None] + frame[..., :, 1] * oy[..., None])
    d = -w_dir
    point_pdf = jnp.full(dir_pdf.shape, 1.0 / (PI * radius * radius))
    return rad, o, d, point_pdf, dir_pdf


def pdf_dir(env: Envmap, d):
    """Solid-angle pdf with which the 2-stage CDF sampler (sample_L /
    sample_Le) produces direction d — the env light's MIS pdf for
    arbitrary directions.  Used by BDPT strategy (d) (eye-walk miss env
    pickup, models/bdpt.py) and the PT pt_mis env pickup
    (models/pathtracer.py); the same p(w) formula as sample_L
    (environment_light.cpp:138-169) evaluated at d's pixel."""
    h, w = env.data.shape[:2]
    x, y = _dir_to_xy(d, w, h)
    xi = jnp.clip(x.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(y.astype(jnp.int32), 0, h - 1)
    u = normalize(d)
    sin_t = jnp.sqrt(jnp.maximum(
        1.0 - jnp.clip(u[..., 1], -1.0, 1.0) ** 2, 0.0))
    return env.pdf[yi, xi] * (w * h) / (2.0 * PI * PI
                                        * jnp.maximum(sin_t, 1e-6))


def sample_L(env: Envmap, p, u4):
    """NEE sample toward the env light: returns (radiance, wi, dist, pdf).

    u4: uniforms [S,4] — (row CDF, col CDF, x jitter, y jitter), matching
    the reference's uv sample + random_uniform jitters
    (environment_light.cpp:149-160).
    """
    h, w = env.data.shape[:2]
    y = jnp.searchsorted(env.marginal_cdf, u4[..., 1], side="right")
    y = jnp.clip(y, 0, h - 1)
    # per-row conditional CDF search
    x = jax.vmap(lambda row, q: jnp.searchsorted(row, q, side="right"))(
        env.conditional_cdf[y], u4[..., 0])
    x = jnp.clip(x, 0, w - 1)
    xf = x.astype(jnp.float32) + u4[..., 2]
    yf = y.astype(jnp.float32) + u4[..., 3]
    theta = yf / h * PI
    phi = xf / w * 2.0 * PI
    wi = jnp.stack([
        jnp.cos(phi - PI) * jnp.sin(theta),
        jnp.cos(theta),
        -jnp.sin(phi - PI) * jnp.sin(theta)], axis=-1)
    pdf = env.pdf[y, x] * (w * h) / (2.0 * PI * PI
                                     * jnp.maximum(jnp.sin(theta), 1e-6))
    rad = _bilerp(env, xf, yf)
    dist = jnp.full(pdf.shape, INF_D)
    return rad, wi, dist, pdf
