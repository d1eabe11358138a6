"""Camera and shading-frame transforms against float64 numpy.

These transforms are written as elementwise f32 products and sums (no dot
products, which a GPU may run in TF32); chip_smoke.py repeats the check on
the card."""

import jax.numpy as jnp
import numpy as np
import pytest

from bidirectional_pathtracing.core.math import (
    make_coord_space, to_local, to_world)
from bidirectional_pathtracing.ops import camera_ops
from bidirectional_pathtracing.scene.procedural import make_cornell_box

TOL = 4e-6      # a few f32 ulps on unit vectors


@pytest.fixture
def cam():
    q, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))
    return make_cornell_box().camera._replace(
        c2w=jnp.asarray(q, jnp.float32),
        lens_radius=jnp.float32(0.05), focal_distance=jnp.float32(3.0))


def _f64(a):
    return np.asarray(a, np.float64)


def _tan_half(deg):
    return np.tan(np.radians(np.float64(deg)) / 2)


def _xy(n=512, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=n).astype(np.float32),
            rng.uniform(size=n).astype(np.float32))


def test_generate_ray_float64(cam):
    x, y = _xy()
    o, d = camera_ops.generate_ray(cam, jnp.asarray(x), jnp.asarray(y))
    dc = np.stack([(2 * _f64(x) - 1) * _tan_half(cam.hfov),
                   (2 * _f64(y) - 1) * _tan_half(cam.vfov),
                   -np.ones(x.shape)], -1)
    dw = dc @ _f64(cam.c2w).T
    dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
    assert np.abs(_f64(d) - dw).max() <= TOL
    assert np.abs(_f64(o) - _f64(cam.pos)).max() == 0.0


def test_generate_ray_thin_lens_float64(cam):
    x, y = _xy(seed=1)
    r, th = _xy(seed=2)
    th = th * np.float32(2 * np.pi)
    o, d = camera_ops.generate_ray_thin_lens(
        cam, jnp.asarray(x), jnp.asarray(y), jnp.asarray(r), jnp.asarray(th))
    lr = np.float64(cam.lens_radius)
    lens = np.stack([lr * np.sqrt(_f64(r)) * np.cos(_f64(th)),
                     lr * np.sqrt(_f64(r)) * np.sin(_f64(th)),
                     np.zeros(r.shape)], -1)
    focus = np.stack([(2 * _f64(x) - 1) * _tan_half(cam.hfov),
                      (2 * _f64(y) - 1) * _tan_half(cam.vfov),
                      -np.ones(x.shape)], -1) * np.float64(cam.focal_distance)
    c2w = _f64(cam.c2w)
    dw = (focus - lens) @ c2w.T
    dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
    assert np.abs(_f64(d) - dw).max() <= TOL
    assert np.abs(_f64(o) - (_f64(cam.pos) + lens @ c2w.T)).max() <= TOL


def test_sample_ray_pdf_float64(cam):
    rng = np.random.default_rng(3)
    p = (np.float64(cam.pos) - 3.0 * (_f64(cam.c2w)[:, 2])
         + rng.normal(scale=0.5, size=(512, 3))).astype(np.float32)
    w, h = 480, 360
    ci = camera_ops.sample_ray_pdf(cam, jnp.asarray(p), w, h)
    wi = _f64(cam.pos) - _f64(p)
    dist = np.linalg.norm(wi, axis=-1)
    wi /= dist[:, None]
    wc = (-wi) @ _f64(cam.c2w) * np.array([1.0, 1.0, -1.0])
    cos_t = wc[:, 2]
    assert (cos_t > 0.5).all()
    th, tv = _tan_half(cam.hfov), _tan_half(cam.vfov)
    px = (wc[:, 0] / cos_t / th + 1.0) * 0.5 * w
    py = (wc[:, 1] / cos_t / tv + 1.0) * 0.5 * h
    np.testing.assert_allclose(_f64(ci.wi), wi, atol=TOL)
    np.testing.assert_allclose(_f64(ci.dist), dist, rtol=TOL)
    np.testing.assert_allclose(_f64(ci.dir_pdf), dist * dist / cos_t,
                               rtol=1e-5)
    np.testing.assert_allclose(_f64(ci.px), px, atol=2e-3)   # pixels
    np.testing.assert_allclose(_f64(ci.py), py, atol=2e-3)
    we = cos_t ** 4 / (4.0 * th * tv)
    np.testing.assert_allclose(_f64(ci.we[:, 0]), we, rtol=1e-5)


def test_coord_space_transforms_float64():
    rng = np.random.default_rng(4)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    v = rng.normal(size=(512, 3)).astype(np.float32)
    frame = make_coord_space(jnp.asarray(n))
    f = _f64(frame)
    # an orthonormal frame whose third column is n
    np.testing.assert_allclose(np.einsum("kij,kil->kjl", f, f),
                               np.broadcast_to(np.eye(3), f.shape),
                               atol=TOL)
    np.testing.assert_allclose(
        f[:, :, 2], _f64(n) / np.linalg.norm(_f64(n), axis=-1,
                                             keepdims=True), atol=TOL)
    world = np.einsum("kij,kj->ki", f, _f64(v))
    local = np.einsum("kij,ki->kj", f, _f64(v))
    assert np.abs(_f64(to_world(frame, jnp.asarray(v))) - world).max() <= TOL
    assert np.abs(_f64(to_local(frame, jnp.asarray(v))) - local).max() <= TOL
