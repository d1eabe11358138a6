"""The brute-force Triton kernel (ops/intersect_triton.py) in interpret
mode against the plain jnp path, plus the wrapper's gradient rule.

The compiled kernel runs on the GPU only; chip_smoke.py compares it with
the plain path there at full width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bidirectional_pathtracing.ops import intersect_triton as K
from bidirectional_pathtracing.ops.intersect import (
    intersect, occluded, resolve_hit)
from bidirectional_pathtracing.scene.procedural import (
    icosphere, make_cornell_box, make_icosphere_box)
from bidirectional_pathtracing.scene.types import make_geometry

N_RAYS = 300        # not a multiple of BLOCK_R: exercises lane padding


def _ico320():
    """The level-2 icosphere alone: 320 triangles, a multiple of the
    kernel's triangle unroll."""
    v, f = icosphere(2, seed=3)
    p = v[f] * 0.6 + np.array([0.0, 0.7, 0.0])
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    return make_geometry(p, n, np.zeros(len(f), np.int32))


def _soup700():
    """700 random triangles, triangles only (no valid sphere)."""
    rng = np.random.default_rng(5)
    c = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.4, 0.9], (700, 1, 3))
    p = c + rng.normal(scale=0.08, size=(700, 3, 3))
    n = np.repeat(rng.normal(size=(700, 1, 3)), 3, axis=1)
    return make_geometry(p, n, rng.integers(0, 5, 700))


GEOMETRIES = {
    "box14_spheres": lambda: make_cornell_box(
        sphere_materials=("mirror", "glass")).geometry,
    "ico2_box332": lambda: make_icosphere_box(2).geometry,
    "ico320": _ico320,
    "soup700": _soup700,
}


def _rays(seed=0):
    """Rays from inside the box with mixed windows: unbounded, short
    segments, and dead lanes (max_t < min_t)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.4, 0.9], (N_RAYS, 3))
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    min_t = np.full(N_RAYS, 1e-4)
    max_t = rng.choice([1e30, 0.3, 1.0, 2.5, -1.0], N_RAYS)
    return tuple(jnp.asarray(a, jnp.float32) for a in (o, d, min_t, max_t))


@pytest.mark.parametrize("geom_name", list(GEOMETRIES))
def test_closest_hit_matches_plain(geom_name):
    g = GEOMETRIES[geom_name]()
    o, d, lo, hi = _rays()
    t, prim = K.closest_hit(g, o, d, lo, hi, interpret=True)
    got = resolve_hit(g, o, d, t, prim)
    ref = intersect(g, o, d, lo, hi)
    assert bool(jnp.any(ref.valid)) and not bool(jnp.all(ref.valid))
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))
    np.testing.assert_array_equal(np.asarray(got.mat), np.asarray(ref.mat))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.n), np.asarray(ref.n),
                               atol=1e-4)
    # dead lanes never hit
    assert not bool(jnp.any(got.valid & (hi < lo)))


@pytest.mark.parametrize("geom_name", list(GEOMETRIES))
def test_any_hit_matches_plain(geom_name):
    g = GEOMETRIES[geom_name]()
    o, d, lo, hi = _rays(1)
    got = K.any_hit(g, o, d, lo, hi, interpret=True)
    ref = occluded(g, o, d, lo, hi)
    assert bool(jnp.any(ref)) and not bool(jnp.all(ref))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_kernel_ray_gradients_are_zero():
    """Hits are not differentiable: the wrapper stops gradients at the
    rays, so d t / d(o, d) is exactly zero and finite."""
    g = GEOMETRIES["box14_spheres"]()
    o, d, lo, hi = _rays(2)

    def loss(o, d):
        t, prim = K.closest_hit(g, o, d, lo, hi, interpret=True)
        return jnp.sum(jnp.where(prim >= 0, t, 0.0))

    go, gd = jax.grad(loss, argnums=(0, 1))(o, d)
    for gr in (go, gd):
        assert np.isfinite(np.asarray(gr)).all()
        assert not np.asarray(gr).any()
