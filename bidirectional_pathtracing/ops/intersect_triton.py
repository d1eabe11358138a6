"""Brute-force ray/primitive intersection as a Pallas kernel (Triton route).

The GPU path for scenes small enough to test every primitive against every
ray (no BVH attached, see scene/build.py attach_accelerator).  The plain
`intersect` / `occluded` in ops/intersect.py build [R, chunk] test matrices
in device memory; this kernel keeps them out of it:

  - one program owns a block of BLOCK_R rays, one ray per lane, read from
    a [8, R] SoA (ox oy oz dx dy dz min_t max_t);
  - it loops over the triangle table [9, T] (v0, e1 = v1 - v0, e2 = v2 - v0)
    with scalar loads that are uniform across the block, TRI_UNROLL
    triangles per iteration, and keeps each lane's running (t, prim) in
    registers;
  - spheres follow as a static tail over a [5, Q] table (cx cy cz r valid);
  - the any-hit variant tests the spheres first and leaves its loop once
    every live lane of the block is blocked.

Semantics are those of the plain path: Möller-Trumbore with the same
operand order, the nearer in-range sphere root, strict `<` so the lowest
triangle index wins t ties, triangles win ties against spheres and the
lowest sphere index wins sphere ties.  All arithmetic is elementwise f32
(no dot products, so no TF32).  The kernel returns (t, prim); the winner's
normal and material are resolved afterwards in jnp with plain gathers.

Rays are wrapped in stop_gradient: hits are not differentiable (as in the
plain path), and gradients flow through the shading algebra only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bidirectional_pathtracing.core.math import INF_D
from bidirectional_pathtracing.scene.types import Geometry

BLOCK_R = 128       # rays per program (one per lane with NUM_WARPS=4)
NUM_WARPS = 4
TRI_UNROLL = 8      # triangles per loop iteration; the table is padded to it


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _tri_test(o, d, min_t, lim, tri_ref, j):
    """Möller-Trumbore of a block of rays against triangle j of the
    table; returns (t, ok) with ok requiring min_t <= t <= lim."""
    v0 = [tri_ref[k, j] for k in range(3)]
    e1 = [tri_ref[3 + k, j] for k in range(3)]
    e2 = [tri_ref[6 + k, j] for k in range(3)]
    s = [o[k] - v0[k] for k in range(3)]
    s1 = [d[(k + 1) % 3] * e2[(k + 2) % 3] - d[(k + 2) % 3] * e2[(k + 1) % 3]
          for k in range(3)]
    s2 = [s[(k + 1) % 3] * e1[(k + 2) % 3] - s[(k + 2) % 3] * e1[(k + 1) % 3]
          for k in range(3)]
    denom = s1[0] * e1[0] + s1[1] * e1[1] + s1[2] * e1[2]
    inv = jnp.where(denom == 0, 0.0, 1.0 / jnp.where(denom == 0, 1.0, denom))
    t = (s2[0] * e2[0] + s2[1] * e2[1] + s2[2] * e2[2]) * inv
    b1 = (s1[0] * s[0] + s1[1] * s[1] + s1[2] * s[2]) * inv
    b2 = (s2[0] * d[0] + s2[1] * d[1] + s2[2] * d[2]) * inv
    ok = ((denom != 0) & (t >= min_t) & (t <= lim)
          & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1))
    return t, ok


def _sphere_test(o, d, min_t, lim, sph_ref, q):
    """Nearer in-range root of sphere q (sphere.cpp:11-57); (t, ok)."""
    c = [sph_ref[k, q] for k in range(3)]
    r = sph_ref[3, q]
    oc = [o[k] - c[k] for k in range(3)]
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    b = 2.0 * (oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2])
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r * r
    delta = b * b - 4.0 * a * cc
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    in1 = (t1 >= min_t) & (t1 <= lim)
    in2 = (t2 >= min_t) & (t2 <= lim)
    ok = (sph_ref[4, q] > 0.0) & (delta >= 0.0) & (in1 | in2)
    return jnp.where(in1, t1, t2), ok


def _load_rays(rays_ref):
    o = [rays_ref[k, :] for k in range(3)]
    d = [rays_ref[3 + k, :] for k in range(3)]
    return o, d, rays_ref[6, :], rays_ref[7, :]


def _closest_kernel(rays_ref, tri_ref, sph_ref, t_ref, prim_ref, *,
                    n_chunks, n_spheres, n_tris):
    o, d, min_t, max_t = _load_rays(rays_ref)

    def chunk(c, carry):
        best_t, best_i = carry
        for u in range(TRI_UNROLL):
            j = c * TRI_UNROLL + u
            t, ok = _tri_test(o, d, min_t, jnp.minimum(max_t, best_t),
                              tri_ref, j)
            closer = ok & (t < best_t)
            best_t = jnp.where(closer, t, best_t)
            best_i = jnp.where(closer, j, best_i)
        return best_t, best_i

    best_t = jnp.full((BLOCK_R,), INF_D, jnp.float32)
    best_i = jnp.full((BLOCK_R,), -1, jnp.int32)
    best_t, best_i = jax.lax.fori_loop(0, n_chunks, chunk, (best_t, best_i))
    for q in range(n_spheres):
        t, ok = _sphere_test(o, d, min_t, jnp.minimum(max_t, best_t),
                             sph_ref, q)
        closer = ok & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_i = jnp.where(closer, n_tris + q, best_i)
    t_ref[...] = best_t
    prim_ref[...] = best_i


def _any_kernel(rays_ref, tri_ref, sph_ref, hit_ref, *, n_chunks,
                n_spheres):
    o, d, min_t, max_t = _load_rays(rays_ref)
    blocked = jnp.zeros((BLOCK_R,), jnp.int32)
    for q in range(n_spheres):
        _, ok = _sphere_test(o, d, min_t, max_t, sph_ref, q)
        blocked = jnp.where(ok, 1, blocked)
    # lanes with an empty window can never be blocked: count them as done
    dead = jnp.where(max_t < min_t, 1, 0)

    def cond(carry):
        c, blocked = carry
        return (c < n_chunks) & (jnp.min(jnp.maximum(blocked, dead)) == 0)

    def body(carry):
        c, blocked = carry
        for u in range(TRI_UNROLL):
            _, ok = _tri_test(o, d, min_t, max_t, tri_ref,
                              c * TRI_UNROLL + u)
            blocked = jnp.where(ok, 1, blocked)
        return c + 1, blocked

    _, blocked = jax.lax.while_loop(cond, body, (jnp.int32(0), blocked))
    hit_ref[...] = blocked


def tri_table(geom: Geometry):
    """[9, Tpad] f32 (v0, e1, e2); invalid and padding rows are zero, a
    degenerate triangle that never hits."""
    p = jnp.where(geom.tri_valid[:, None, None], geom.tri_p, 0.0)
    rows = jnp.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]],
                           axis=1).T.astype(jnp.float32)
    tpad = _ceil_to(max(geom.num_tris, 1), TRI_UNROLL)
    return jnp.pad(rows, ((0, 0), (0, tpad - geom.num_tris)))


def sphere_table(geom: Geometry):
    """[5, Q] f32 (cx cy cz r valid)."""
    return jnp.concatenate([
        geom.sph_c.T, geom.sph_r[None, :],
        geom.sph_valid[None, :].astype(jnp.float32)]).astype(jnp.float32)


def _pack_rays(o, d, min_t, max_t):
    """[8, Rpad] ray SoA; padding lanes get an empty window."""
    r = o.shape[0]
    rp = _ceil_to(max(r, 1), BLOCK_R)
    o, d = jax.lax.stop_gradient((o, d))
    min_t = jax.lax.stop_gradient(
        jnp.broadcast_to(jnp.asarray(min_t, jnp.float32), (r,)))
    max_t = jax.lax.stop_gradient(
        jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (r,)))
    rays = jnp.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                      min_t, max_t]).astype(jnp.float32)
    pad = jnp.broadcast_to(
        jnp.array([0, 0, 0, 0, 0, 1, 0, -1], jnp.float32)[:, None],
        (8, rp - r))
    return jnp.concatenate([rays, pad], axis=1), rp


def _call(kernel, geom, o, d, min_t, max_t, out_dtypes, interpret, name):
    rays, rp = _pack_rays(o, d, min_t, max_t)
    tris = jax.lax.stop_gradient(tri_table(geom))
    sph = jax.lax.stop_gradient(sphere_table(geom))
    kernel = functools.partial(kernel, n_chunks=tris.shape[1] // TRI_UNROLL,
                               n_spheres=geom.num_spheres)
    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((rp,), dt) for dt in out_dtypes],
        grid=(rp // BLOCK_R,),
        in_specs=[pl.BlockSpec((8, BLOCK_R), lambda i: (0, i)),
                  pl.BlockSpec(tris.shape, lambda i: (0, 0)),
                  pl.BlockSpec(sph.shape, lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((BLOCK_R,), lambda i: (i,))
                   for _ in out_dtypes],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(rays, tris, sph)
    return [x[:o.shape[0]] for x in outs]


def closest_hit(geom: Geometry, o, d, min_t, max_t, interpret=False):
    """(t [R] f32, INF_D on a miss; prim [R] int32, -1 on a miss).  Global
    prim ids: [0, T) triangles, [T, T+Q) spheres."""
    kernel = functools.partial(_closest_kernel, n_tris=geom.num_tris)
    t, prim = _call(kernel, geom, o, d, min_t, max_t,
                    (jnp.float32, jnp.int32), interpret, "closest_hit")
    return t, prim


def any_hit(geom: Geometry, o, d, min_t, max_t, interpret=False):
    """bool [R]: some primitive lies in the ray's [min_t, max_t] window."""
    (hit,) = _call(_any_kernel, geom, o, d, min_t, max_t, (jnp.int32,),
                   interpret, "any_hit")
    return hit > 0
