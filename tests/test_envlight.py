"""Environment light vs reference oracle (CDF importance sampling, bilerp
lookup, NEE integration) on bunny_unlit with a synthetic HDR envmap."""

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")


def _synthetic_env():
    H, W = 64, 128
    y, x = np.mgrid[0:H, 0:W]
    theta = (y + 0.5) / H * np.pi
    img = np.zeros((H, W, 3), np.float32)
    img[..., 2] = 0.4 + 0.4 * np.cos(theta)
    img[..., 0] = 0.2 + 0.2 * np.sin(theta)
    img[..., 1] = 0.25 + 0.2 * np.cos(theta)
    cx, cy = W // 4, H // 4
    blob = np.exp(-(((x - cx) / 3.0) ** 2 + ((y - cy) / 3.0) ** 2))
    img += 40.0 * blob[..., None] * np.array([1.0, 0.9, 0.7], np.float32)
    return img


def test_env_pdf_normalised():
    from bidirectional_pathtracing.ops import envlight
    env = envlight.build_envmap(_synthetic_env())
    assert abs(float(env.pdf.sum()) - 1.0) < 1e-4
    assert abs(float(env.marginal_cdf[-1]) - 1.0) < 1e-4


def test_env_sample_L_is_unbiased_estimator():
    """E[L/pdf] over env samples equals the cosine-free env integral."""
    import jax
    import jax.numpy as jnp
    from bidirectional_pathtracing.ops import envlight
    img = _synthetic_env()
    env = envlight.build_envmap(img)
    n = 100_000
    u4 = jax.random.uniform(jax.random.key(0), (n, 4))
    p = jnp.zeros((n, 3))
    rad, wi, dist, pdf = envlight.sample_L(env, p, u4)
    est = float(jnp.mean(jnp.sum(rad, -1) / jnp.maximum(pdf, 1e-9)))
    # exact integral of sum(L) over the sphere (equirect with sin weight)
    h, w = img.shape[:2]
    theta = (np.arange(h) + 0.5) / h * np.pi
    exact = float((img.sum(-1) * np.sin(theta)[:, None]).sum()
                  * (np.pi / h) * (2 * np.pi / w))
    assert abs(est - exact) / exact < 0.05, (est, exact)


def test_env_sample_Le_geometry_and_pdf():
    """sample_Le (infinite-light emission, EXTENSION): every emitted ray
    must cross the scene bounding sphere, the disk point pdf is uniform
    1/(pi r^2), and E[sum(L)/dir_pdf] equals the env integral (the
    direction stream is the same CDF sampler as sample_L)."""
    import jax
    import jax.numpy as jnp
    from bidirectional_pathtracing.ops import envlight
    img = _synthetic_env()
    env = envlight.build_envmap(img)
    n = 50_000
    center = jnp.asarray([1.0, -2.0, 0.5])
    radius = 3.0
    k = jax.random.key(3)
    u4 = jax.random.uniform(jax.random.fold_in(k, 0), (n, 4))
    u2 = jax.random.uniform(jax.random.fold_in(k, 1), (n, 2))
    rad, o, d, point_pdf, dir_pdf = envlight.sample_Le(
        env, center, radius, u4, u2)
    np.testing.assert_allclose(np.asarray(point_pdf),
                               1.0 / (np.pi * radius * radius), rtol=1e-6)
    # unit directions
    np.testing.assert_allclose(
        np.asarray(jnp.linalg.norm(d, axis=-1)), 1.0, atol=1e-5)
    # each ray's closest approach to the center is inside the sphere and
    # the origin lies outside it, pointing inward
    oc = np.asarray(o) - np.asarray(center)
    dn = np.asarray(d)
    t_closest = -(oc * dn).sum(-1)
    assert (t_closest > 0).all()           # pointed toward the scene
    dist = np.linalg.norm(oc + t_closest[:, None] * dn, axis=-1)
    assert (dist <= radius + 1e-4).all()   # sweeps the bounding sphere
    assert (np.linalg.norm(oc, axis=-1) >= radius * 1.5).all()
    # direction pdf: same unbiased-integral check as sample_L
    est = float(jnp.mean(jnp.sum(rad, -1) / jnp.maximum(dir_pdf, 1e-9)))
    h, w = img.shape[:2]
    theta = (np.arange(h) + 0.5) / h * np.pi
    exact = float((img.sum(-1) * np.sin(theta)[:, None]).sum()
                  * (np.pi / h) * (2 * np.pi / w))
    assert abs(est - exact) / exact < 0.05, (est, exact)


@pytest.mark.slow
def test_env_render_matches_oracle():
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.ops import envlight
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils.render import render
    scene, _ = load_scene(f"{REFERENCE}/dae/sky/bunny_unlit.dae", 120, 90)
    scene = scene._replace(envmap=envlight.build_envmap(_synthetic_env()))
    cfg = RenderConfig(spp=8, max_ray_depth=5, width=120, height=90,
                       integrator="pt", light_samples=4)
    res = render(scene, cfg)
    ref = np.load("tests/golden/bunny_unlit_env_pt_120x90_16spp.npz")

    def blocks(img, nb=6):
        h, w = img.shape[:2]
        bh, bw = h // nb, w // nb
        return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))

    err = np.abs(blocks(ref["combined"]) - blocks(res.combined)) \
        / (np.abs(blocks(ref["combined"])) + 0.05)
    assert err.mean() < 0.03, err.mean()
    assert err.max() < 0.12, err.max()
