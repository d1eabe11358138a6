"""Camera ray generation and BDPT camera importance sampling.

  - generate_ray: pinhole NDC ray (reference src/pathtracer/camera.cpp:191-212)
  - generate_ray_thin_lens: depth of field (camera_lens.cpp:22-43)
  - sample_ray_pdf: camera importance We = 1/(A cos^4 theta) with
    A = 4 tan(hFov/2) tan(vFov/2), dir_pdf = d^2/cos(theta), point_pdf = 1,
    and reprojection to pixel coordinates for light-image splats
    (camera.cpp:214-248, per pbr-book 16.1)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from bidirectional_pathtracing.core.math import mat_vec, normalize
from bidirectional_pathtracing.scene.types import Camera


def _tan_half(deg):
    return jnp.tan(jnp.radians(deg) / 2.0)


def generate_ray(cam: Camera, x, y):
    """Pinhole rays for NDC coords x,y in [0,1]; returns (o[S,3], d[S,3]).

    min_t/max_t are cam.nclip/cam.fclip (applied by the caller).
    """
    dx = (2.0 * x - 1.0) * _tan_half(cam.hfov)
    dy = (2.0 * y - 1.0) * _tan_half(cam.vfov)
    d_cam = jnp.stack([dx, dy, -jnp.ones_like(dx)], axis=-1)
    d = normalize(mat_vec(cam.c2w, d_cam))
    o = jnp.broadcast_to(cam.pos, d.shape)
    return o, d


def generate_ray_thin_lens(cam: Camera, x, y, rnd_r, rnd_theta):
    """Thin-lens rays (camera_lens.cpp:22-43); falls back to pinhole when
    lens_radius == 0 (the sampled lens point collapses to the origin)."""
    lr = cam.lens_radius
    p_lens = jnp.stack([
        lr * jnp.sqrt(rnd_r) * jnp.cos(rnd_theta),
        lr * jnp.sqrt(rnd_r) * jnp.sin(rnd_theta),
        jnp.zeros_like(rnd_r)], axis=-1)
    dx = (2.0 * x - 1.0) * _tan_half(cam.hfov)
    dy = (2.0 * y - 1.0) * _tan_half(cam.vfov)
    ray_dir = jnp.stack([dx, dy, -jnp.ones_like(dx)], axis=-1)
    p_focus = ray_dir * cam.focal_distance
    d = normalize(mat_vec(cam.c2w, p_focus - p_lens))
    o = cam.pos + mat_vec(cam.c2w, p_lens)
    return o, d


class CameraImportance(NamedTuple):
    we: jnp.ndarray         # [S,3] importance 1/(A cos^4)
    wi: jnp.ndarray         # [S,3] unit, from p toward the camera
    point: jnp.ndarray      # [S,3] camera position
    dist: jnp.ndarray       # [S]
    point_pdf: jnp.ndarray  # [S] == 1
    dir_pdf: jnp.ndarray    # [S] d^2/cos(theta)
    normal: jnp.ndarray     # [S,3] == -wi (reference convention)
    px: jnp.ndarray         # f32 [S] target pixel x (unclamped)
    py: jnp.ndarray         # f32 [S] target pixel y
    in_frame: jnp.ndarray   # bool [S] in front of the camera and on screen


def sample_ray_pdf(cam: Camera, p, width: int, height: int) -> CameraImportance:
    """Camera::sample_ray_pdf (camera.cpp:214-248) for a wavefront p [S,3]."""
    wi = cam.pos - p
    dist = jnp.linalg.norm(wi, axis=-1)
    wi = wi / jnp.maximum(dist, 1e-20)[..., None]
    # wc = w2c * (-wi) with z flipped (camera looks down -z)
    w2c = cam.c2w.T
    wc = mat_vec(w2c, -wi)
    wc = wc * jnp.array([1.0, 1.0, -1.0])
    cos_t = wc[..., 2]                      # cos(theta) toward the view axis
    th = _tan_half(cam.hfov)
    tv = _tan_half(cam.vfov)
    area = 4.0 * th * tv
    denom = area / jnp.maximum(cos_t, 1e-12) ** 4
    we = jnp.where((cos_t > 0)[..., None], 1.0 / denom[..., None], 0.0)
    dir_pdf = dist * dist / jnp.maximum(cos_t, 1e-12)

    wc_n = wc / jnp.maximum(cos_t, 1e-12)[..., None]
    px = (wc_n[..., 0] / th + 1.0) * 0.5 * width
    py = (wc_n[..., 1] / tv + 1.0) * 0.5 * height
    # Bounds use the reference's int-cast semantics (camera.cpp:241-242 +
    # bidirection.cpp:459): C++ double->int truncates toward zero, so the
    # band (-1,0) lands in pixel 0 and is ACCEPTED.  This matters: We has a
    # 1/cos^4 tail that peaks exactly at the frame border.
    in_frame = ((cos_t > 0) & (px > -1.0) & (py > -1.0)
                & (px < width) & (py < height))
    return CameraImportance(
        we=we, wi=wi, point=jnp.broadcast_to(cam.pos, p.shape), dist=dist,
        point_pdf=jnp.ones_like(dist), dir_pdf=dir_pdf, normal=-wi,
        px=px, py=py, in_frame=in_frame)
