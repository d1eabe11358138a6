"""BVH construction (host-side) and flattening for device traversal.

Build mirrors the reference algorithm (reference src/scene/bvh.cpp:51-129):
recursive spatial-midpoint split on the largest-extent centroid axis, with
a mean-split fallback when all centroids land on one side, leaves up to
max_leaf_size (default 4, bvh.h:61).  The tree is then linearised in
pre-order with escape links: node i's subtree occupies [i, escape[i]), so
device traversal needs no stack.

The hot build loop runs in the native C++ builder (ops/native, ctypes)
when available, else in numpy.  Construction happens once per scene on the
host — on device the BVH is just flat arrays (scene.types.BVHArrays).
"""

from __future__ import annotations

import numpy as np

from bidirectional_pathtracing.scene.types import BVHArrays, Geometry


def _primitive_bounds(geom: Geometry):
    import numpy as np
    tp = np.asarray(geom.tri_p, np.float64)
    tv = np.asarray(geom.tri_valid)
    sc = np.asarray(geom.sph_c, np.float64)
    sr = np.asarray(geom.sph_r, np.float64)
    sv = np.asarray(geom.sph_valid)
    t = tp.shape[0]
    lo = np.concatenate([tp.min(axis=1), sc - sr[:, None]], axis=0)
    hi = np.concatenate([tp.max(axis=1), sc + sr[:, None]], axis=0)
    valid = np.concatenate([tv, sv])
    ids = np.arange(lo.shape[0], dtype=np.int32)
    return lo[valid], hi[valid], ids[valid]


def build_bvh(geom: Geometry, max_leaf_size: int = 4) -> BVHArrays:
    lo, hi, ids = _primitive_bounds(geom)
    try:
        from bidirectional_pathtracing.ops.native import bvh_build_native
        nodes = bvh_build_native(lo, hi, max_leaf_size)
    except Exception:
        nodes = _build_numpy(lo, hi, max_leaf_size)
    (bounds_lo, bounds_hi, is_leaf, prim_start, prim_count, escape,
     order) = nodes
    import jax.numpy as jnp
    return BVHArrays(
        bounds_lo=jnp.asarray(bounds_lo, jnp.float32),
        bounds_hi=jnp.asarray(bounds_hi, jnp.float32),
        is_leaf=jnp.asarray(is_leaf),
        prim_start=jnp.asarray(prim_start, jnp.int32),
        prim_count=jnp.asarray(prim_count, jnp.int32),
        escape=jnp.asarray(escape, jnp.int32),
        prim_order=jnp.asarray(ids[order], jnp.int32),
    )


def _build_numpy(lo, hi, max_leaf_size, sah: bool = False):
    """Pre-order recursive build; returns flat arrays + primitive order.

    sah=True splits with a binned surface-area heuristic (16 bins, all 3
    axes) instead of the reference's midpoint rule — same fallback role as
    the native builder's bvh_build_sah (ops/native/bvh_builder.cpp)."""
    n = lo.shape[0]
    cent = (lo + hi) * 0.5
    order = np.arange(n)

    bounds_lo, bounds_hi = [], []
    is_leaf, prim_start, prim_count, escape = [], [], [], []
    out_order = []

    def _split_midpoint(idx, c):
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        mid = (c[:, axis].max() + c[:, axis].min()) * 0.5
        return idx[c[:, axis] < mid], idx[c[:, axis] >= mid], axis

    def _half_area(blo, bhi):
        d = np.maximum(bhi - blo, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
            + d[..., 2] * d[..., 0]

    def _split_sah(idx, c):
        NB = 16
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        best = (np.inf, -1, -1.0)  # cost, axis, plane
        for axis in range(3):
            ext = cmax[axis] - cmin[axis]
            if ext < 1e-12:
                continue
            b = np.clip(((c[:, axis] - cmin[axis]) * (NB / ext)).astype(
                np.int64), 0, NB - 1)
            cnt = np.bincount(b, minlength=NB)
            blo = np.full((NB, 3), np.inf)
            bhi = np.full((NB, 3), -np.inf)
            for a in range(3):
                np.minimum.at(blo[:, a], b, lo[idx, a])
                np.maximum.at(bhi[:, a], b, hi[idx, a])
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)
            rcnt = np.cumsum(cnt[::-1])[::-1]
            for k in range(1, NB):
                if lcnt[k - 1] == 0 or rcnt[k] == 0:
                    continue
                cost = _half_area(llo[k - 1], lhi[k - 1]) * lcnt[k - 1] \
                    + _half_area(rlo[k], rhi[k]) * rcnt[k]
                if cost < best[0]:
                    best = (cost, axis, cmin[axis] + k * (ext / NB))
        _, axis, plane = best
        if axis < 0:
            return _split_midpoint(idx, c)
        return idx[c[:, axis] < plane], idx[c[:, axis] >= plane], axis

    def rec(idx):
        node_id = len(is_leaf)
        blo = lo[idx].min(axis=0)
        bhi = hi[idx].max(axis=0)
        bounds_lo.append(blo)
        bounds_hi.append(bhi)
        is_leaf.append(False)
        prim_start.append(0)
        prim_count.append(0)
        escape.append(0)
        if len(idx) <= max_leaf_size:
            is_leaf[node_id] = True
            prim_start[node_id] = len(out_order)
            prim_count[node_id] = len(idx)
            out_order.extend(idx.tolist())
        else:
            c = cent[idx]
            left, right, axis = (_split_sah if sah else _split_midpoint)(
                idx, c)
            if len(left) == 0 or len(right) == 0:
                # degenerate: split by median of centroid order
                srt = idx[np.argsort(c[:, axis], kind="stable")]
                half = len(srt) // 2
                left, right = srt[:half], srt[half:]
            rec(left)
            rec(right)
        escape[node_id] = len(is_leaf)
        return node_id

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(order)
    finally:
        sys.setrecursionlimit(old)
    return (np.array(bounds_lo, np.float32), np.array(bounds_hi, np.float32),
            np.array(is_leaf), np.array(prim_start, np.int32),
            np.array(prim_count, np.int32), np.array(escape, np.int32),
            np.array(out_order, np.int64))
