"""Differentiability: pixel gradients vs finite differences (BASELINE
gradcheck).  The detached-sampling estimator keeps all sampling decisions
fixed under differentiation, so common-random-number finite differences are
smooth and comparable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.models import bdpt, pathtracer as pt
from bidirectional_pathtracing.core import rng
from bidirectional_pathtracing.scene.procedural import make_cornell_box

pytestmark = pytest.mark.slow

W, H = 24, 16


@pytest.fixture(scope="module")
def box():
    return make_cornell_box()


def _bdpt_loss(scene, cfg, key):
    pix = jnp.arange(W * H, dtype=jnp.int32)
    eye, light = bdpt.sample_pass(scene, key, W, H, pix, cfg)
    return jnp.mean(eye) + jnp.mean(light)


def _pt_loss(scene, cfg, key):
    pix = jnp.arange(W * H, dtype=jnp.int32)
    keys = rng.lane_keys(key, pix)
    o, d = pt.sample_camera_rays(scene, keys, W, H, pix, cfg)
    return jnp.mean(pt.trace_radiance(scene, o, d, keys, cfg))


@pytest.mark.parametrize("integrator,loss_fn,field", [
    # BDPT's emission lever is the light-table radiance (the reference
    # replaces hit emission with light->sample_pdf radiance,
    # bidirection.cpp:307-328), so material emission is tested under PT.
    ("bdpt", _bdpt_loss, "albedo"),
    ("pt", _pt_loss, "albedo"),
    ("pt", _pt_loss, "emission"),
])
def test_gradcheck_vs_finite_differences(box, integrator, loss_fn, field):
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=W, height=H,
                       integrator=integrator)
    key = jax.random.key(0)

    def loss_of(val):
        mats = box.materials._replace(**{field: val})
        return loss_fn(box._replace(materials=mats), cfg, key)

    base = getattr(box.materials, field)
    g = jax.grad(loss_of)(base)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0, "gradient is identically zero"

    # finite differences on the few largest entries
    flat = np.argsort(-np.abs(g).ravel())[:4]
    eps = 1e-2
    for idx in flat:
        i, j = np.unravel_index(idx, g.shape)
        e = np.zeros_like(g)
        e[i, j] = eps
        fp = float(loss_of(base + e))
        fm = float(loss_of(base - e))
        fd = (fp - fm) / (2 * eps)
        assert abs(fd - g[i, j]) <= 0.05 * max(abs(fd), abs(g[i, j]), 1e-3), \
            (field, (i, j), fd, g[i, j])


def test_light_radiance_gradient(box):
    """Gradients also flow to the light table radiance (inverse lighting)."""
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=W, height=H,
                       integrator="bdpt")
    key = jax.random.key(1)

    def loss_of(rad):
        lights = box.lights._replace(radiance=rad)
        return _bdpt_loss(box._replace(lights=lights), cfg, key)

    g = np.asarray(jax.grad(loss_of)(box.lights.radiance))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    # radiance enters linearly: grad ~ loss/radiance
    base = float(loss_of(box.lights.radiance))
    pred = float((g * np.asarray(box.lights.radiance)).sum())
    assert abs(pred - base) < 0.05 * abs(base)
