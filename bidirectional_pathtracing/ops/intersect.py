"""Ray-scene intersection (closest hit + any hit / shadow rays).

Numerical semantics match the reference primitives exactly:
  - Möller–Trumbore triangles with barycentric-interpolated smooth normals
    (reference src/scene/triangle.cpp:57-95)
  - quadratic ray-sphere with nearer-root preference and analytic normals
    (reference src/scene/sphere.cpp:11-93)
  - closest-hit via global min over primitives, equivalent to the
    reference's mutable ray.max_t shrinking (bvh.cpp:161-188)
  - segment any-hit semantics for shadow rays ([min_t, max_t] clipping,
    bidirection.cpp:423-430)

The wavefront design replaces per-ray BVH recursion with batched primitive
streams: rays are a [R] wavefront; primitives are scanned in fixed-size
chunks via lax.scan so peak memory stays [R, CHUNK].  Three paths share
these semantics (`intersector` picks one per scene and backend): the plain
jnp scan below, the brute-force Triton kernel on the GPU
(ops/intersect_triton.py), and the escape-link BVH walk for large scenes
(`intersect_bvh`).  The plain scan is the reference the other two are
tested against.

Hits are treated as non-differentiable (stop_gradient at the call sites):
gradients w.r.t. materials/emission flow through the shading algebra only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bidirectional_pathtracing.core.math import EPS_F, INF_D
from bidirectional_pathtracing.scene.types import Geometry

_TRI_CHUNK = 512


class Hit(NamedTuple):
    t: jnp.ndarray        # f32 [R]  (INF_D when miss)
    valid: jnp.ndarray    # bool [R]
    n: jnp.ndarray        # f32 [R,3] shading normal (unnormalised ok? no: unit)
    mat: jnp.ndarray      # int32 [R] material id (-1 on miss)
    prim: jnp.ndarray     # int32 [R] global prim id (-1 on miss)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_axis0(a: jnp.ndarray, n: int):
    pad = n - a.shape[0]
    if pad == 0:
        return a
    return jnp.concatenate(
        [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)


def tri_intersect_batch(o, d, p0, p1, p2, min_t, max_t):
    """Möller–Trumbore for a [R] ray wavefront against [T] triangles.

    Returns (t[R,T], b1[R,T], b2[R,T], hit[R,T]).  o,d: [R,3]; p*: [T,3];
    min_t/max_t: [R].
    """
    e1 = p1 - p0                      # [T,3]
    e2 = p2 - p0
    # componentwise [R,T] algebra (no [R,T,3] temporaries), so XLA can fuse
    # the whole test into the consumer's reduction
    ox, oy, oz = (o[:, k][:, None] for k in range(3))
    dx, dy, dz = (d[:, k][:, None] for k in range(3))
    sx, sy, sz = ox - p0[:, 0], oy - p0[:, 1], oz - p0[:, 2]
    s1x = dy * e2[:, 2] - dz * e2[:, 1]
    s1y = dz * e2[:, 0] - dx * e2[:, 2]
    s1z = dx * e2[:, 1] - dy * e2[:, 0]
    s2x = sy * e1[:, 2] - sz * e1[:, 1]
    s2y = sz * e1[:, 0] - sx * e1[:, 2]
    s2z = sx * e1[:, 1] - sy * e1[:, 0]
    denom = s1x * e1[:, 0] + s1y * e1[:, 1] + s1z * e1[:, 2]
    inv = jnp.where(denom == 0, 0.0, 1.0 / jnp.where(denom == 0, 1.0, denom))
    t = (s2x * e2[:, 0] + s2y * e2[:, 1] + s2z * e2[:, 2]) * inv
    b1 = (s1x * sx + s1y * sy + s1z * sz) * inv
    b2 = (s2x * dx + s2y * dy + s2z * dz) * inv
    hit = ((denom != 0) & (t >= min_t[:, None]) & (t <= max_t[:, None])
           & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1))
    return t, b1, b2, hit


def sphere_intersect_batch(o, d, c, r, min_t, max_t):
    """Quadratic sphere test (sphere.cpp:11-57) for [R] rays x [Q] spheres.

    Returns (t[R,Q], hit[R,Q]) taking the nearer in-range root.
    """
    oc = o[:, None, :] - c[None]                   # [R,Q,3]
    a = jnp.sum(d * d, axis=-1)[:, None]           # [R,1]
    b = 2.0 * jnp.sum(oc * d[:, None, :], axis=-1)  # [R,Q]
    cc = jnp.sum(oc * oc, axis=-1) - (r * r)[None]
    delta = b * b - 4.0 * a * cc
    ok = delta >= 0
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t1_in = (t1 >= min_t[:, None]) & (t1 <= max_t[:, None])
    t2_in = (t2 >= min_t[:, None]) & (t2 <= max_t[:, None])
    t = jnp.where(t1_in, t1, t2)
    hit = ok & (t1_in | t2_in)
    return t, hit


def sphere_merge(geom, o, d, min_b, max_b,
                 best_t, best_n, best_mat, best_prim, prim_base):
    """Merge sphere hits into the running best hit.

    The winning sphere's attributes come from static per-column selects
    over the (tiny) sphere table, which fuse into the surrounding
    elementwise work.  Tie-breaking matches argmin (lowest sphere index
    wins).
    """
    ns = geom.sph_c.shape[0]
    ts, hs = sphere_intersect_batch(
        o, d, geom.sph_c, geom.sph_r, min_b, jnp.minimum(max_b, best_t))
    hs = hs & geom.sph_valid[None, :]
    ts = jnp.where(hs, ts, INF_D)
    tj = jnp.min(ts, axis=-1)
    r = o.shape[0]
    sc = jnp.zeros((r, 3), o.dtype)
    smat = jnp.zeros((r,), jnp.int32)
    sidx = jnp.zeros((r,), jnp.int32)
    for k in range(ns - 1, -1, -1):
        w = ts[:, k] <= tj
        sc = jnp.where(w[:, None], geom.sph_c[k], sc)
        smat = jnp.where(w, geom.sph_mat[k], smat)
        sidx = jnp.where(w, jnp.int32(k), sidx)
    closer = tj < best_t
    p_hit = o + tj[:, None] * d
    nrm = p_hit - sc
    nrm = nrm / jnp.maximum(
        jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return (jnp.where(closer, tj, best_t),
            jnp.where(closer[:, None], nrm, best_n),
            jnp.where(closer, smat, best_mat),
            jnp.where(closer, prim_base + sidx, best_prim))


def intersect(geom: Geometry, o, d, min_t, max_t) -> Hit:
    """Closest-hit over all primitives.  o,d: [R,3]; min_t,max_t: [R] or scalar."""
    r_count = o.shape[0]
    min_t = jnp.broadcast_to(jnp.asarray(min_t, o.dtype), (r_count,))
    max_t = jnp.broadcast_to(jnp.asarray(max_t, o.dtype), (r_count,))

    best_t = jnp.full((r_count,), INF_D, o.dtype)
    best_n = jnp.zeros((r_count, 3), o.dtype)
    best_mat = jnp.full((r_count,), -1, jnp.int32)
    best_prim = jnp.full((r_count,), -1, jnp.int32)

    num_t = geom.num_tris
    tc = min(_TRI_CHUNK, _ceil_to(max(num_t, 1), 8))
    tp = _ceil_to(num_t, tc)
    tri_p = _pad_axis0(geom.tri_p, tp).reshape(tp // tc, tc, 3, 3)
    tri_n = _pad_axis0(geom.tri_n, tp).reshape(tp // tc, tc, 3, 3)
    tri_mat = _pad_axis0(geom.tri_mat, tp).reshape(tp // tc, tc)
    tri_valid = _pad_axis0(geom.tri_valid, tp).reshape(tp // tc, tc)
    tri_base = jnp.arange(tp, dtype=jnp.int32).reshape(tp // tc, tc)

    def tri_step(carry, chunk):
        bt, bn, bm, bp = carry
        cp, cn, cm, cv, cid = chunk
        t, b1, b2, hit = tri_intersect_batch(
            o, d, cp[:, 0], cp[:, 1], cp[:, 2], min_t, jnp.minimum(max_t, bt))
        hit = hit & cv[None, :]
        t = jnp.where(hit, t, INF_D)
        j = jnp.argmin(t, axis=-1)                   # [R]
        rows = jnp.arange(r_count)
        tj = t[rows, j]
        closer = tj < bt
        b1j = b1[rows, j][:, None]
        b2j = b2[rows, j][:, None]
        nj = (cn[j, 0] * (1.0 - b1j - b2j) + cn[j, 1] * b1j + cn[j, 2] * b2j)
        nj = nj / jnp.maximum(
            jnp.linalg.norm(nj, axis=-1, keepdims=True), 1e-20)
        bt = jnp.where(closer, tj, bt)
        bn = jnp.where(closer[:, None], nj, bn)
        bm = jnp.where(closer, cm[j], bm)
        bp = jnp.where(closer, cid[j], bp)
        return (bt, bn, bm, bp), None

    if num_t > 0:
        (best_t, best_n, best_mat, best_prim), _ = jax.lax.scan(
            tri_step, (best_t, best_n, best_mat, best_prim),
            (tri_p, tri_n, tri_mat, tri_valid, tri_base))

    # spheres (few; single batch of static selects)
    num_q = geom.num_spheres
    if num_q > 0:
        best_t, best_n, best_mat, best_prim = sphere_merge(
            geom, o, d, min_t, max_t, best_t, best_n, best_mat, best_prim,
            jnp.int32(num_t))

    valid = best_t < INF_D
    return Hit(t=best_t, valid=valid, n=best_n, mat=best_mat, prim=best_prim)


def occluded(geom: Geometry, o, d, min_t, max_t) -> jnp.ndarray:
    """Any-hit [R] for shadow segments (visibility test).

    Mirrors the reference's use of bvh->intersect on a [EPS, dist-EPS]
    segment (bidirection.cpp:418-433); implemented without the reference's
    leaf-miss traversal bug (bvh.cpp:142-157), which the reference never
    exercises for shadow rays because it calls the closest-hit path.
    """
    r_count = o.shape[0]
    min_t = jnp.broadcast_to(jnp.asarray(min_t, o.dtype), (r_count,))
    max_t = jnp.broadcast_to(jnp.asarray(max_t, o.dtype), (r_count,))
    hit_any = jnp.zeros((r_count,), bool)

    num_t = geom.num_tris
    if num_t > 0:
        tc = min(_TRI_CHUNK, _ceil_to(max(num_t, 1), 8))
        tp = _ceil_to(num_t, tc)
        tri_p = _pad_axis0(geom.tri_p, tp).reshape(tp // tc, tc, 3, 3)
        tri_valid = _pad_axis0(geom.tri_valid, tp).reshape(tp // tc, tc)

        def step(carry, chunk):
            cp, cv = chunk
            _, _, _, hit = tri_intersect_batch(
                o, d, cp[:, 0], cp[:, 1], cp[:, 2], min_t, max_t)
            return carry | jnp.any(hit & cv[None, :], axis=-1), None

        hit_any, _ = jax.lax.scan(step, hit_any, (tri_p, tri_valid))

    if geom.num_spheres > 0:
        _, hit = sphere_intersect_batch(
            o, d, geom.sph_c, geom.sph_r, min_t, max_t)
        hit_any = hit_any | jnp.any(hit & geom.sph_valid[None, :], axis=-1)
    return hit_any


def occluded_segment(geom: Geometry, a, b, rel_eps: float = 2e-4):
    """Visibility test between points a and b [R,3].

    The reference clips shadow segments to [EPS, dist - EPS] in double
    precision (bidirection.cpp:423-430), where the endpoint's own primitive
    falls outside max_t exactly.  In float32 the sphere quadratic's
    cancellation error (~1e-5 * dist) exceeds the absolute epsilon and
    falsely self-occludes endpoints lying ON a sphere, so we clip the far
    end by a RELATIVE margin instead.  Returns (blocked[R], dir[R,3],
    dist[R]).
    """
    d = b - a
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-20))
    conn = d / dist[..., None]
    max_t = dist * (1.0 - rel_eps) - EPS_F
    blocked = occluded(geom, a, conn, EPS_F, max_t)
    return blocked, conn, dist


# --- BVH traversal (flattened pre-order, escape links) ----------------------

def _bvh_slab(o, inv_d, lo, hi, min_t, max_t):
    """Slab test (bbox.cpp:10-56) vectorized; returns hit mask."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tmax >= tmin) & (tmax >= min_t) & (tmin <= max_t)


def _leaf_prims(geom, bvh, start, count, leaf_size):
    """Gather up to leaf_size global prim ids for a leaf; -1 padded."""
    slots = []
    for j in range(leaf_size):
        pid = bvh.prim_order[jnp.clip(start + j, 0, bvh.prim_order.shape[0] - 1)]
        slots.append(jnp.where(j < count, pid, -1))
    return slots


def intersect_bvh(geom: Geometry, bvh, o, d, min_t, max_t,
                  leaf_size: int = 4, any_hit: bool = False):
    """Closest-hit (or any-hit) via stackless pre-order traversal.

    Each ray walks the linearised tree with an escape-link pointer
    (bvh.cpp:161-188 semantics, without recursion); rays advance in
    lockstep inside a lax.while_loop until all reach the end sentinel.
    """
    r_count = o.shape[0]
    n_nodes = bvh.is_leaf.shape[0]
    num_t = geom.num_tris
    min_t = jnp.broadcast_to(jnp.asarray(min_t, o.dtype), (r_count,))
    max_t = jnp.broadcast_to(jnp.asarray(max_t, o.dtype), (r_count,))
    inv_d = jnp.where(d == 0, INF_D, 1.0 / jnp.where(d == 0, 1.0, d))

    def test_prim(pid, best_t):
        """Unified tri/sphere test for global prim id [R]. Returns
        (t, n, mat) with t=INF on miss."""
        is_tri = (pid >= 0) & (pid < num_t)
        tid = jnp.clip(pid, 0, num_t - 1)
        tp = geom.tri_p[tid]
        e1 = tp[:, 1] - tp[:, 0]
        e2 = tp[:, 2] - tp[:, 0]
        sv = o - tp[:, 0]
        s1 = jnp.cross(d, e2)
        s2 = jnp.cross(sv, e1)
        den = jnp.sum(s1 * e1, axis=-1)
        inv = jnp.where(den == 0, 0.0, 1.0 / jnp.where(den == 0, 1.0, den))
        t_tri = jnp.sum(s2 * e2, axis=-1) * inv
        b1 = jnp.sum(s1 * sv, axis=-1) * inv
        b2 = jnp.sum(s2 * d, axis=-1) * inv
        tri_ok = (is_tri & (den != 0) & (t_tri >= min_t)
                  & (t_tri <= jnp.minimum(max_t, best_t))
                  & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1))
        tn = geom.tri_n[tid]
        n_tri = (tn[:, 0] * (1.0 - b1 - b2)[:, None] + tn[:, 1] * b1[:, None]
                 + tn[:, 2] * b2[:, None])
        n_tri = n_tri / jnp.maximum(
            jnp.linalg.norm(n_tri, axis=-1, keepdims=True), 1e-20)

        is_sph = pid >= num_t
        qid = jnp.clip(pid - num_t, 0, geom.num_spheres - 1)
        c = geom.sph_c[qid]
        r = geom.sph_r[qid]
        oc = o - c
        b = 2.0 * jnp.sum(oc * d, axis=-1)
        cc = jnp.sum(oc * oc, axis=-1) - r * r
        delta = b * b - 4.0 * cc
        sq = jnp.sqrt(jnp.maximum(delta, 0.0))
        t1s = (-b - sq) / 2.0
        t2s = (-b + sq) / 2.0
        lim = jnp.minimum(max_t, best_t)
        in1 = (t1s >= min_t) & (t1s <= lim)
        in2 = (t2s >= min_t) & (t2s <= lim)
        t_sph = jnp.where(in1, t1s, t2s)
        sph_ok = is_sph & (delta >= 0) & (in1 | in2)
        p_hit = o + t_sph[:, None] * d
        n_sph = (p_hit - c)
        n_sph = n_sph / jnp.maximum(
            jnp.linalg.norm(n_sph, axis=-1, keepdims=True), 1e-20)

        t_out = jnp.where(tri_ok, t_tri, jnp.where(sph_ok, t_sph, INF_D))
        n_out = jnp.where(tri_ok[:, None], n_tri,
                          jnp.where(sph_ok[:, None], n_sph, 0.0))
        mat = jnp.where(tri_ok, geom.tri_mat[tid],
                        jnp.where(sph_ok, geom.sph_mat[qid], -1))
        return t_out, n_out, mat

    def cond(state):
        ptr = state[0]
        if any_hit:
            return jnp.any((ptr < n_nodes) & ~state[1])
        return jnp.any(ptr < n_nodes)

    def body(state):
        ptr, hit_flag, best_t, best_n, best_mat, best_prim = state
        idx = jnp.clip(ptr, 0, n_nodes - 1)
        active = ptr < n_nodes
        lo = bvh.bounds_lo[idx]
        hi = bvh.bounds_hi[idx]
        box_hit = active & _bvh_slab(o, inv_d, lo, hi, min_t,
                                     jnp.minimum(max_t, best_t))
        leaf = bvh.is_leaf[idx]
        start = bvh.prim_start[idx]
        count = bvh.prim_count[idx]
        do_leaf = box_hit & leaf
        for pid in _leaf_prims(geom, bvh, start, count, 4):
            pid = jnp.where(do_leaf, pid, -1)
            t, n, mat = test_prim(pid, best_t)
            closer = t < best_t
            best_n = jnp.where(closer[:, None], n, best_n)
            best_mat = jnp.where(closer, mat, best_mat)
            best_prim = jnp.where(closer, pid, best_prim)
            best_t = jnp.where(closer, t, best_t)
            hit_flag = hit_flag | closer
        nxt = jnp.where(box_hit & ~leaf, idx + 1, bvh.escape[idx])
        ptr = jnp.where(active, nxt, ptr)
        if any_hit:
            ptr = jnp.where(hit_flag, n_nodes, ptr)
        return (ptr, hit_flag, best_t, best_n, best_mat, best_prim)

    state = (
        jnp.zeros((r_count,), jnp.int32),
        jnp.zeros((r_count,), bool),
        jnp.full((r_count,), INF_D, o.dtype),
        jnp.zeros((r_count, 3), o.dtype),
        jnp.full((r_count,), -1, jnp.int32),
        jnp.full((r_count,), -1, jnp.int32),
    )
    state = jax.lax.while_loop(cond, body, state)
    _, hit_flag, best_t, best_n, best_mat, best_prim = state
    if any_hit:
        return hit_flag
    return Hit(t=best_t, valid=best_t < INF_D, n=best_n, mat=best_mat,
               prim=best_prim)


# --- scene-level dispatch ---------------------------------------------------

# chip_smoke.py sets this to time the plain jnp path against the kernel on
# the GPU; it is not a user option.
_PLAIN_ONLY = False


def intersector(scene) -> str:
    """The intersection path for `scene` on the current backend.

    "bvh"    a BVH is attached (attach_accelerator does so from the prim
             count): escape-link traversal, on every backend;
    "kernel" GPU without a BVH: the brute-force Triton kernel
             (ops/intersect_triton.py);
    "brute"  otherwise: the plain chunked jnp scan.
    """
    if scene.bvh is not None:
        return "bvh"
    if jax.default_backend() == "gpu" and not _PLAIN_ONLY:
        return "kernel"
    return "brute"


def resolve_hit(geom: Geometry, o, d, t, prim) -> Hit:
    """Hit record for a winning (t, prim) pair: the triangle's interpolated
    normal (barycentrics recomputed as in `intersect`) or the sphere's
    analytic normal, and the winner's material."""
    num_t = geom.num_tris
    found = (prim >= 0) & (t < INF_D)
    tri_hit = found & (prim < num_t)
    sph_hit = found & (prim >= num_t)
    tid = jnp.clip(prim, 0, num_t - 1)
    tp = geom.tri_p[tid]
    e1 = tp[:, 1] - tp[:, 0]
    e2 = tp[:, 2] - tp[:, 0]
    sv = o - tp[:, 0]
    s1 = jnp.cross(d, e2)
    s2 = jnp.cross(sv, e1)
    den = jnp.sum(s1 * e1, axis=-1)
    inv = jnp.where(den == 0, 0.0, 1.0 / jnp.where(den == 0, 1.0, den))
    b1 = (jnp.sum(s1 * sv, axis=-1) * inv)[:, None]
    b2 = (jnp.sum(s2 * d, axis=-1) * inv)[:, None]
    tn = geom.tri_n[tid]
    n = tn[:, 0] * (1.0 - b1 - b2) + tn[:, 1] * b1 + tn[:, 2] * b2
    mat = geom.tri_mat[tid]
    best_t = jnp.where(found, t, INF_D)
    if geom.num_spheres > 0:
        qid = jnp.clip(prim - num_t, 0, geom.num_spheres - 1)
        n = jnp.where(sph_hit[:, None],
                      o + best_t[:, None] * d - geom.sph_c[qid], n)
        mat = jnp.where(sph_hit, geom.sph_mat[qid], mat)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return Hit(t=best_t, valid=found,
               n=jnp.where(found[:, None], n, 0.0),
               mat=jnp.where(found, mat, -1),
               prim=jnp.where(found, prim, -1))


def scene_intersect(scene, o, d, min_t, max_t) -> Hit:
    """Closest hit through the path `intersector` picks (the role of the
    reference's BVH traversal, bvh.cpp:161-188)."""
    path = intersector(scene)
    if path == "bvh":
        return intersect_bvh(scene.geometry, scene.bvh, o, d, min_t, max_t)
    if path == "kernel":
        from bidirectional_pathtracing.ops import intersect_triton
        t, prim = intersect_triton.closest_hit(scene.geometry, o, d,
                                               min_t, max_t)
        return resolve_hit(scene.geometry, o, d, t, prim)
    return intersect(scene.geometry, o, d, min_t, max_t)


def scene_occluded(scene, o, d, min_t, max_t):
    """Any hit [R] through the path `intersector` picks."""
    path = intersector(scene)
    if path == "bvh":
        return intersect_bvh(scene.geometry, scene.bvh, o, d, min_t, max_t,
                             any_hit=True)
    if path == "kernel":
        from bidirectional_pathtracing.ops import intersect_triton
        return intersect_triton.any_hit(scene.geometry, o, d, min_t, max_t)
    return occluded(scene.geometry, o, d, min_t, max_t)


def scene_occluded_segment(scene, a, b, rel_eps: float = 2e-4, active=None):
    """occluded_segment through the scene's intersection path.

    active: optional [R] mask; inactive segments get an empty t-window
    (reported unblocked — callers mask their contributions anyway), which
    lets the any-hit kernel count them as done.
    """
    d = b - a
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-20))
    conn = d / dist[..., None]
    max_t = dist * (1.0 - rel_eps) - EPS_F
    if active is not None:
        max_t = jnp.where(active, max_t, -1.0)
    blocked = scene_occluded(scene, a, conn, EPS_F, max_t)
    return blocked, conn, dist
