"""Which intersection path a scene takes, the BVH walk against brute
force on a large mesh, and where the compile cache lives."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bidirectional_pathtracing.ops import intersect as isect
from bidirectional_pathtracing.scene.build import attach_accelerator
from bidirectional_pathtracing.scene.procedural import (
    make_cornell_box, make_icosphere_box)
from bidirectional_pathtracing.utils import compile_cache


@pytest.fixture(scope="module")
def ico5():
    return attach_accelerator(make_icosphere_box(5))


@pytest.mark.parametrize("backend,scene_name,expect", [
    ("gpu", "box14", "kernel"),
    ("gpu", "ico4", "bvh"),
    ("cpu", "box14", "brute"),
    ("cpu", "ico4", "bvh"),
])
def test_intersector_by_backend_and_prim_count(monkeypatch, backend,
                                               scene_name, expect):
    scene = (make_cornell_box() if scene_name == "box14"
             else make_icosphere_box(4))          # 5,132 tris > 2,048
    scene = attach_accelerator(scene)
    assert (scene.bvh is None) == (scene_name == "box14")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert isect.intersector(scene) == expect


def test_plain_switch_keeps_bvh(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(isect, "_PLAIN_ONLY", True)
    assert isect.intersector(make_cornell_box()) == "brute"
    assert isect.intersector(
        attach_accelerator(make_icosphere_box(4))) == "bvh"


def _rays(n=384, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.4, 0.9], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo = np.full(n, 1e-4)
    hi = rng.choice([1e30, 0.4, 1.2], n)
    return tuple(jnp.asarray(a, jnp.float32) for a in (o, d, lo, hi))


def test_bvh_closest_matches_brute_ico5(ico5):
    g = ico5.geometry
    assert g.num_tris == 20492
    rays = _rays()
    got = isect.intersect_bvh(g, ico5.bvh, *rays)
    ref = isect.intersect(g, *rays)
    assert 0.2 < float(jnp.mean(ref.valid)) < 1.0
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.n), np.asarray(ref.n),
                               atol=1e-4)


def test_bvh_any_hit_matches_brute_ico5(ico5):
    g = ico5.geometry
    rays = _rays(seed=1)
    got = isect.intersect_bvh(g, ico5.bvh, *rays, any_hit=True)
    ref = isect.occluded(g, *rays)
    assert bool(jnp.any(ref)) and not bool(jnp.all(ref))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
