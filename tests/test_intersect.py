"""Intersection kernel tests: analytic cases + closest-hit semantics."""

import jax.numpy as jnp
import numpy as np

from bidirectional_pathtracing.ops.intersect import intersect, occluded
from bidirectional_pathtracing.scene.types import make_geometry


def _simple_geom():
    # one unit triangle in z=0 plane + one sphere at (0,0,-3)
    tri_p = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    tri_n = np.array([[[0, 0, 1]] * 3], np.float32)
    return make_geometry(tri_p, tri_n, [0],
                         sph_c=[[0, 0, -3]], sph_r=[0.5], sph_mat=[1])


def test_triangle_hit_and_normal():
    g = _simple_geom()
    o = jnp.array([[0.2, 0.2, 1.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect(g, o, d, 0.0, 100.0)
    assert bool(h.valid[0])
    assert abs(float(h.t[0]) - 1.0) < 1e-6
    np.testing.assert_allclose(np.asarray(h.n[0]), [0, 0, 1], atol=1e-6)
    assert int(h.mat[0]) == 0


def test_triangle_miss_outside_barycentrics():
    g = _simple_geom()
    o = jnp.array([[0.9, 0.9, 1.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect(g, o, d, 0.0, 100.0)
    assert not bool(h.valid[0])


def test_sphere_closest_root():
    g = _simple_geom()
    o = jnp.array([[0.2, 0.2, 2.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    # passes through triangle at t=2 then sphere at t≈4.5+
    h = intersect(g, o, d, 0.0, 100.0)
    assert abs(float(h.t[0]) - 2.0) < 1e-6  # triangle is closer
    h2 = intersect(g, o, d, 2.5, 100.0)     # skip the triangle
    assert int(h2.mat[0]) == 1
    # sphere center (0,0,-3) r=0.5: near root at z=-2.5+eps (ray off-axis)
    assert 4.4 < float(h2.t[0]) < 4.7
    n = np.asarray(h2.n[0])
    assert n[2] > 0.8  # outward normal toward the ray origin


def test_sphere_inside_far_root():
    g = _simple_geom()
    o = jnp.array([[0.0, 0.0, -3.0]])   # at sphere center
    d = jnp.array([[0.0, 0.0, -1.0]])
    h = intersect(g, o, d, 1e-4, 100.0)
    assert abs(float(h.t[0]) - 0.5) < 1e-5


def test_occluded_segment_semantics():
    g = _simple_geom()
    o = jnp.array([[0.2, 0.2, 1.0], [0.2, 0.2, 1.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    # segment ending before the triangle is unoccluded
    occ = occluded(g, o, d, jnp.array([1e-4, 1e-4]), jnp.array([0.5, 2.0]))
    assert not bool(occ[0])
    assert bool(occ[1])


def test_max_t_shrink_equivalence():
    """Closest hit equals brute-force min over primitives."""
    rng = np.random.default_rng(0)
    T = 33
    tri_p = rng.uniform(-1, 1, (T, 3, 3)).astype(np.float32)
    tri_n = np.tile(np.array([[0, 0, 1]], np.float32), (T, 3, 1)).reshape(T, 3, 3)
    g = make_geometry(tri_p, tri_n, np.arange(T, dtype=np.int32))
    o = jnp.asarray(rng.uniform(-2, 2, (50, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(50, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    h = intersect(g, o, d, 1e-4, 1e30)
    # brute force in numpy (double precision)
    on, dn = np.asarray(o, np.float64), np.asarray(d, np.float64)
    tp = tri_p.astype(np.float64)
    best = np.full(50, np.inf)
    for i in range(T):
        e1 = tp[i, 1] - tp[i, 0]
        e2 = tp[i, 2] - tp[i, 0]
        s = on - tp[i, 0]
        s1 = np.cross(dn, e2)
        s2 = np.cross(s, e1)
        denom = s1 @ e1
        ok = np.abs(denom) > 1e-12
        t = np.where(ok, (s2 * e2).sum(-1) / np.where(ok, denom, 1), np.inf)
        b1 = np.where(ok, (s1 * s).sum(-1) / np.where(ok, denom, 1), -1)
        b2 = np.where(ok, (s2 * dn).sum(-1) / np.where(ok, denom, 1), -1)
        hit = (t >= 1e-4) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1)
        best = np.where(hit & (t < best), t, best)
    ht = np.asarray(h.t)
    miss = ~np.isfinite(best)
    assert np.array_equal(miss, ~np.asarray(h.valid))
    np.testing.assert_allclose(ht[~miss], best[~miss], rtol=2e-4, atol=2e-4)
