"""BVH build + traversal vs brute-force equivalence (SURVEY.md section 4:
BVH vs brute-force intersection equivalence)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import REFERENCE, reference_available

from bidirectional_pathtracing.ops.intersect import (
    intersect, intersect_bvh)
from bidirectional_pathtracing.scene.bvh import build_bvh
from bidirectional_pathtracing.scene.procedural import make_cornell_box


def _random_rays(n, seed, lo=-1.5, hi=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _check_equivalence(geom, bvh, n_rays=512, seed=0):
    o, d = _random_rays(n_rays, seed)
    h_ref = intersect(geom, o, d, 1e-4, 1e30)
    h_bvh = intersect_bvh(geom, bvh, o, d, 1e-4, 1e30)
    np.testing.assert_array_equal(np.asarray(h_ref.valid),
                                  np.asarray(h_bvh.valid))
    m = np.asarray(h_ref.valid)
    np.testing.assert_allclose(np.asarray(h_bvh.t)[m],
                               np.asarray(h_ref.t)[m], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(h_bvh.mat)[m],
                                  np.asarray(h_ref.mat)[m])
    # any-hit agrees with closest-hit existence on full segments
    occ = intersect_bvh(geom, bvh, o, d, 1e-4, 1e30, any_hit=True)
    np.testing.assert_array_equal(np.asarray(occ), m)


def test_bvh_cornell_box():
    scene = make_cornell_box()
    bvh = build_bvh(scene.geometry)
    n = int(bvh.is_leaf.shape[0])
    assert n >= 3
    # escape of the root covers the whole tree
    assert int(bvh.escape[0]) == n
    _check_equivalence(scene.geometry, bvh)


@pytest.mark.skipif(not reference_available(), reason="no reference scenes")
@pytest.mark.slow
def test_bvh_cbbunny_large_mesh():
    from bidirectional_pathtracing.scene.build import load_scene
    scene, aux = load_scene(f"{REFERENCE}/dae/sky/CBbunny.dae", 120, 90)
    assert aux["num_tris"] > 20000
    bvh = build_bvh(scene.geometry)
    _check_equivalence(scene.geometry, bvh, n_rays=256, seed=1)


def test_native_builder_matches_numpy():
    scene = make_cornell_box()
    from bidirectional_pathtracing.scene import bvh as bvh_mod
    lo, hi, ids = bvh_mod._primitive_bounds(scene.geometry)
    try:
        from bidirectional_pathtracing.ops.native import bvh_build_native
        native = bvh_build_native(lo, hi, 4)
    except Exception as e:  # pragma: no cover
        pytest.skip(f"native toolchain unavailable: {e}")
    ref = bvh_mod._build_numpy(lo, hi, 4)
    assert native[0].shape == ref[0].shape  # same node count
    np.testing.assert_array_equal(native[2], ref[2])      # is_leaf
    np.testing.assert_array_equal(native[5], ref[5])      # escape
    np.testing.assert_allclose(native[0], ref[0], atol=1e-6)
