"""Bidirectional path tracer (Veach BDPT) — wavefront, fully vectorized.

Port of the *math* of the reference BidirectionalPathTracer
(reference src/pathtracer/bidirection.cpp) to fixed-shape JAX:

  - prepare_bidirectional_subpath (bidirection.cpp:20-102) becomes a
    lax.scan random walk producing per-vertex arrays with the exact
    recurrences  v.p = p_{i-1} * pdf_{i-1} * G  and
    alpha_i = alpha_{i-1} * |cos(prev_n, d)| * f_{i-1} / pdf_{i-1}.
  - sample_light_ray (bidirection.cpp:105-118): uniform light pick,
    point_pdf /= num_lights.
  - estimate_bidirection_radiance (bidirection.cpp:296-469): all (s,t)
    connection combos enumerated statically; the four cases (t=0 eye hits
    light; t=1 fresh light sample; s=1 camera connection with pixel
    reprojection and light-image splats; general s,t>1) computed under
    masks.
  - multiple_importance_sampling_weight (bidirection.cpp:121-293): the
    pdf-ratio walks along both subpaths, power-2 heuristic, with the
    delta-vertex skip rule (bidirection.cpp:216-219, 284-287).  Unlike
    the reference — which invokes BSDF::sample_pdf with a zero wo vector
    (bidirection.cpp:150 "filled with empty for now") — every edge is
    priced with the TRUE arrival direction (identical values for every
    reference BSDF kind, whose MIS pdfs ignore wo; required for the exact
    microfacet NDF pdf, which the reference cannot price at all).
  - Russian roulette is disabled (q == 1 everywhere), matching the
    reference's commented-out roulette (bidirection.cpp:87-93).

Subpath vertex indexing matches the reference: index 1 is the camera /
light-source vertex, surface vertices run 2..max_depth+1 (the walk stops
once i >= max_ray_depth + 1, bidirection.cpp:84-86).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Environment-light strategy families (see the env section of
# sample_pass): "mis" runs env NEE and env subpath splats MIS-weighted
# against each other; "nee" (set this attribute to bisect bias/variance)
# disables the subpath family and gives env NEE weight 1 — same
# expectation.
_ENV_STRATEGY = "mis"

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.core.math import (
    EPS_F, INF_D, make_coord_space, normalize, to_local, to_world,
)
from bidirectional_pathtracing.core import rng
from bidirectional_pathtracing.ops import bsdf as bsdf_ops
from bidirectional_pathtracing.ops import camera_ops
from bidirectional_pathtracing.ops import lights as light_ops
from bidirectional_pathtracing.ops.intersect import (
    scene_intersect, scene_occluded_segment)
from bidirectional_pathtracing.scene.types import Scene


class Subpath(NamedTuple):
    """Vertex arrays [S, NV+1, ...]; slot 0 unused (the reference's pseudo
    v0), slot 1 = camera/light vertex, slots 2.. = surface vertices."""

    pos: jnp.ndarray      # [S,NV+1,3]
    n: jnp.ndarray        # [S,NV+1,3]  isect normal (v1: init normal)
    alpha: jnp.ndarray    # [S,NV+1,3]
    p: jnp.ndarray        # [S,NV+1]    cumulative area-measure pdf
    mat: jnp.ndarray      # [S,NV+1]    material id (-1 at v1 / invalid)
    valid: jnp.ndarray    # [S,NV+1]
    dir_pdf: jnp.ndarray  # [S]         v1 directional pdf (light/eye start)


def _prepare_subpath(scene: Scene, o, d, point_pdf, dir_pdf, init_radiance,
                     init_normal, keys, site: int, nv: int,
                     first_min_t, first_max_t, adjoint: bool = False):
    """Random walk producing a Subpath with nv real vertices (1..nv).

    keys: per-lane PRNG keys [S]; site: static constant separating the eye
    and light walks' random streams.  adjoint: light-subpath walk — BSDF
    values in alpha use the adjoint orientation (ops/bsdf.py sample).

    Returns (Subpath, steps) — steps = (d_step [S, nv-1, 3],
    miss [S, nv-1]): the ray direction of each walk step (the one
    producing vertex m+2 at step m) and whether a LIVE lane missed the
    scene on it.  alpha at the would-be vertex is computable from
    previous-vertex quantities only, so Subpath.alpha[:, m+2] is valid
    even on a miss — together these feed the eye-walk env-miss pickup
    strategy (d) in sample_pass.
    """
    s = o.shape[0]

    v1_alpha = init_radiance / point_pdf[..., None]

    def step(carry, xs):
        (o, d, prev_pdf, prev_f, prev_n, alpha_prev, p_prev, alive,
         min_t, max_t) = carry
        u3 = xs
        # dead lanes get an empty [min_t, max_t] window: they can never hit
        # (observationally identical — their outputs are masked by `alive`)
        hit = scene_intersect(scene, o, d, min_t,
                              jnp.where(alive, max_t, -1.0))
        miss = alive & ~hit.valid
        alive = alive & hit.valid
        hit_p = o + hit.t[..., None] * d

        cos_prev = jnp.abs(jnp.sum(prev_n * d, axis=-1))
        g = cos_prev * jnp.abs(jnp.sum(hit.n * d, axis=-1)) \
            / jnp.maximum(hit.t * hit.t, 1e-12)
        p_i = p_prev * prev_pdf * g
        alpha_i = alpha_prev * (cos_prev / prev_pdf)[..., None] * prev_f

        # next direction
        o2w = make_coord_space(hit.n)
        w_out = to_local(o2w, -d)
        bs = bsdf_ops.sample(scene.materials, hit.mat, w_out, u3,
                             adjoint=adjoint)
        wi_w = normalize(to_world(o2w, bs.wi))

        out = (hit_p, hit.n, alpha_i, p_i, hit.mat, alive, d, miss)
        carry = (hit_p, wi_w, bs.pdf, bs.f, hit.n, alpha_i, p_i, alive,
                 jnp.full((s,), EPS_F), jnp.full((s,), INF_D))
        return carry, out

    us = site if isinstance(site, jnp.ndarray) else (
        jnp.stack([rng.uniform(rng.fold(keys, site + i), (3,))
                   for i in range(nv - 1)]) if nv > 1 else None)
    # prev_pdf starts at the v1 directional pdf (bidirection.cpp:41)
    init = (o, d, jnp.maximum(dir_pdf, 1e-12), jnp.ones((s, 3)), init_normal,
            v1_alpha, point_pdf, jnp.ones((s,), bool),
            jnp.broadcast_to(first_min_t, (s,)),
            jnp.broadcast_to(first_max_t, (s,)))
    if nv > 1:
        _, outs = jax.lax.scan(step, init, us)
        (pos_s, n_s, alpha_s, p_s, mat_s, valid_s, d_s,
         miss_s) = outs  # each [nv-1, S, ...]
    else:
        pos_s = jnp.zeros((0, s, 3))
        n_s = jnp.zeros((0, s, 3))
        alpha_s = jnp.zeros((0, s, 3))
        p_s = jnp.zeros((0, s))
        mat_s = jnp.zeros((0, s), jnp.int32)
        valid_s = jnp.zeros((0, s), bool)
        d_s = jnp.zeros((0, s, 3))
        miss_s = jnp.zeros((0, s), bool)

    def stack(v1, rest, extra_dims):
        # [S, nv+1, ...]: slot0 zero, slot1 = v1, slots 2.. = walk outputs
        zero = jnp.zeros_like(v1)
        return jnp.concatenate(
            [zero[:, None], v1[:, None], jnp.moveaxis(rest, 0, 1)], axis=1)

    path = Subpath(
        pos=stack(o, pos_s, 3),
        n=stack(init_normal, n_s, 3),
        alpha=stack(v1_alpha, alpha_s, 3),
        p=stack(point_pdf, p_s, 0),
        mat=jnp.concatenate([
            jnp.full((s, 2), -1, jnp.int32), jnp.moveaxis(mat_s, 0, 1)],
            axis=1),
        valid=jnp.concatenate([
            jnp.zeros((s, 1), bool), jnp.ones((s, 1), bool),
            jnp.moveaxis(valid_s, 0, 1)], axis=1),
        dir_pdf=dir_pdf,
    )
    return path, (jnp.moveaxis(d_s, 0, 1), jnp.moveaxis(miss_s, 0, 1))


def _vert(path: Subpath, i: int):
    """Static-index vertex view: dict of [S,...] arrays."""
    return dict(pos=path.pos[:, i], n=path.n[:, i], alpha=path.alpha[:, i],
                p=path.p[:, i], mat=path.mat[:, i], valid=path.valid[:, i])


def _mis_pdf_local(scene, mat, wo_world, wi_world, n):
    """BSDF MIS pdf in the local frame of n, with the TRUE arrival
    direction wo.  For every reference BSDF kind this equals the
    reference's sample_pdf(wo=empty, wi) convention
    (bidirection.cpp:150,189) — their MIS pdfs ignore wo — so diffuse /
    delta scenes replay the reference bitwise; microfacet (which the
    reference cannot price at all, advanced_bsdf.cpp:144-148) gets the
    exact NDF pdf (ops/bsdf.py mis_pdf)."""
    o2w = make_coord_space(n)
    return bsdf_ops.mis_pdf(scene.materials, mat,
                            to_local(o2w, wo_world), to_local(o2w, wi_world))


def _is_delta(scene, mat):
    return bsdf_ops.is_delta(scene.materials, mat)


def _seg(a_pos, b_pos):
    """Direction a->b (unit), distance."""
    d = b_pos - a_pos
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-20))
    return d / dist[..., None], dist


def _pg(scene, prev_pos, prev_n, prev_mat, prev2_pos, cur_pos, cur_n):
    """p * G of sampling cur from prev, having arrived at prev from
    prev2: BSDF MIS pdf (true arrival direction) times the bidirectional
    geometry factor."""
    wi, dist = _seg(prev_pos, cur_pos)
    wo, _ = _seg(prev_pos, prev2_pos)
    p = _mis_pdf_local(scene, prev_mat, wo, wi, prev_n)
    g = jnp.abs(jnp.sum(wi * prev_n, axis=-1)
                * jnp.sum(wi * cur_n, axis=-1)) \
        / jnp.maximum(dist * dist, 1e-12)
    return p * g


def _mis_tables(scene: Scene, eye: Subpath, light: Subpath | None,
                consistent_camera: bool = False):
    """Combo-independent MIS ingredients, computed ONCE per pass.

    consistent_camera=False replicates the reference exactly: the
    current-strategy denominator for the camera->first-hit step is pinned
    to 1*1 (bidirection.cpp:203-210) while alternative strategies price
    the same step as camera dir_pdf * G (bidirection.cpp:246-249) — an
    internally inconsistent convention that bends the partition of unity
    by a few percent near the view axis.  With True, the denominator uses
    the same dir_pdf * G convention and the partition is exact
    (tests/test_mis.py::test_mis_weights_consistent_camera).

    For interior walk steps the reference recomputes sample_pdf and the
    geometry factor per (s,t) combo (bidirection.cpp:121-293) — but those
    values depend only on the subpaths, so we tabulate:
      A_e[i]: numerator p*G of sampling eye[i] from eye[i+1], arriving at
              eye[i+1] from eye[i+2] (used for i <= i_eye-2; the
              i = i_eye-1 step arrives from the connection partner and is
              combo-specific, computed in _mis_weight)
      B_e[i]: denominator p*G of sampling eye[i] from eye[i-1], arriving
              from eye[i-2] (1 at i=2)
      D_e[i]: delta-skip mask for the (eye[i], eye[i-1]) step
    and the light-path analogues (B_l[1] = light v1 area pdf,
    B_l[2] = light dir_pdf * G).  The junction step of each walk and the
    junction-adjacent step remain combo-specific.
    """
    s = eye.pos.shape[0]
    nv = eye.pos.shape[1] - 1
    one = jnp.ones((s,))
    t = {"A_e": {}, "B_e": {}, "D_e": {}, "A_l": {}, "B_l": {}, "D_l": {}}
    for i in range(2, nv + 1):
        if i + 2 <= nv:
            t["A_e"][i] = _pg(scene, eye.pos[:, i + 1], eye.n[:, i + 1],
                              eye.mat[:, i + 1], eye.pos[:, i + 2],
                              eye.pos[:, i], eye.n[:, i])
        if i == 2 and consistent_camera:
            ci = camera_ops.sample_ray_pdf(scene.camera, eye.pos[:, 2], 1, 1)
            wi, dist = _seg(eye.pos[:, 1], eye.pos[:, 2])
            g = jnp.abs(jnp.sum(wi * eye.n[:, 2], axis=-1)) \
                / jnp.maximum(dist * dist, 1e-12)
            t["B_e"][i] = ci.dir_pdf * g
        elif i == 2:
            t["B_e"][i] = one
        else:
            t["B_e"][i] = _pg(
                scene, eye.pos[:, i - 1], eye.n[:, i - 1], eye.mat[:, i - 1],
                eye.pos[:, i - 2], eye.pos[:, i], eye.n[:, i])
        t["D_e"][i] = (_is_delta(scene, eye.mat[:, i])
                       | _is_delta(scene, eye.mat[:, i - 1]))
    if light is not None:
        for i in range(1, nv + 1):
            if i + 2 <= nv:
                t["A_l"][i] = _pg(scene, light.pos[:, i + 1],
                                  light.n[:, i + 1], light.mat[:, i + 1],
                                  light.pos[:, i + 2],
                                  light.pos[:, i], light.n[:, i])
            if i == 1:
                t["B_l"][i] = light.p[:, 1]
            elif i == 2:
                wi, dist = _seg(light.pos[:, 1], light.pos[:, 2])
                g = jnp.abs(jnp.sum(wi * light.n[:, 1], axis=-1)
                            * jnp.sum(wi * light.n[:, 2], axis=-1)) \
                    / jnp.maximum(dist * dist, 1e-12)
                t["B_l"][i] = light.dir_pdf * g
            else:
                t["B_l"][i] = _pg(scene, light.pos[:, i - 1],
                                  light.n[:, i - 1], light.mat[:, i - 1],
                                  light.pos[:, i - 2],
                                  light.pos[:, i], light.n[:, i])
            t["D_l"][i] = (_is_delta(scene, light.mat[:, i])
                           | _is_delta(scene, light.mat[:, i - 1]))

    # Suffix-square sums for the table-form weight (see _mis_weight):
    #   W_e[k] = sum_{i=2}^{k-2} Dbar_e[i] * (prod_{j=i}^{k-2} a_e[j])^2
    # with a_e[j] = A_e[j]/max(B_e[j], eps) and Dbar = 1 - delta-skip,
    # via the O(nv) recurrence W(k+1) = a[k-1]^2 * (W(k) + Dbar[k-1]) —
    # zeros in a (delta vertices) propagate exactly like the sequential
    # walk's dead ratios.  Light side: W_l[k] analogous with i down to 1.
    zero = jnp.zeros((s,))

    def _suffix_sums(A, B, D, lo):
        a = {j: A[j] / jnp.maximum(B[j], 1e-20) for j in A}
        dbar = {j: jnp.where(D[j], 0.0, 1.0) for j in D}
        w = {lo: zero, lo + 1: zero}
        for k in range(lo + 1, nv):
            prev = a[k - 1] * a[k - 1] * (w[k] + dbar[k - 1]) \
                if (k - 1) in a else zero
            w[k + 1] = prev
        return w

    t["W_e"] = _suffix_sums(t["A_e"], t["B_e"], t["D_e"], 2)
    if light is not None:
        t["W_l"] = _suffix_sums(t["A_l"], t["B_l"], t["D_l"], 1)
    return t


def _junction_pg(scene, prev, prev2_pos, cur_pos, cur_n,
                 use_dir_pdf: bool):
    """Junction-step numerator: pdf of sampling cur from the OTHER
    subpath's endpoint `prev` (a vertex dict, arrived at from prev2_pos),
    times geometry.  use_dir_pdf: prev is a light/camera source vertex
    whose directional pdf is stored (prev2_pos unused)."""
    wi, dist = _seg(prev["pos"], cur_pos)
    if use_dir_pdf:
        p = prev["dir_pdf"]
    else:
        wo, _ = _seg(prev["pos"], prev2_pos)
        p = _mis_pdf_local(scene, prev["mat"], wo, wi, prev["n"])
    g = jnp.abs(jnp.sum(wi * prev["n"], axis=-1)
                * jnp.sum(wi * cur_n, axis=-1)) \
        / jnp.maximum(dist * dist, 1e-12)
    return p * g


def _mis_weight(scene: Scene, i_eye: int, i_light: int,
                eye: Subpath, light: Subpath,
                light_sample: dict | None, eye_sample: dict | None,
                eye_on_light_pdfs, tables: dict | None = None,
                consistent_camera: bool = False,
                t1_reference: bool = False):
    """multiple_importance_sampling_weight (bidirection.cpp:121-293),
    restructured around precomputed per-subpath tables (_mis_tables): the
    pdf-ratio walks only evaluate the combo-specific junction terms; all
    interior p*G factors come from the tables.  Semantics identical to the
    reference (validated by the oracle path-replay tests) except the t=1
    fix below.

    eye_on_light_pdfs: (found, point_pdf, dir_pdf_fn) for the t=0 case.

    t1_reference: reproduce a REFERENCE DEFECT in the t=1 light-walk
    junction.  The t=1 estimator connects to a FRESH light point
    (bidirection.cpp:332-358), but the reference's light walk prices
    `light_path[i]` — the unrelated light-SUBPATH vertex — in that
    strategy's alternative-pdf ratio (bidirection.cpp:226: cur_v =
    light_path[i] even when i_light==1 uses light_sample).  The realized
    weights for the actual fresh-sampled path then do not partition
    unity.  On diffuse scenes the error is sub-percent, but on near-delta
    microfacet conductors the alternative that would dampen a
    lobe-aligned fresh sample (BSDF-sampling it, NDF pdf ~1e2) is priced
    at the wrong point, so w(s,1) stays ~1 instead of ~1e-3: measured r04
    on CBspheres_microfacet_al_ag, unsuppressed 500x fireflies and a ~2x
    bright limb block versus three converging referees (hemisphere-PT,
    MIS-PT, and BDPT's own (3,0) family).  Default False = price the
    fresh point (Veach-correct); True only for reference path replay.

    TABLE FORM (r05): each walk's interior is a geometric accumulation —
    ratio(i) = C * prod_{j=i}^{end-2} a[j] with a[j] = A[j]/B[j] — so
    the per-combo sum collapses to O(1) using the precomputed
    suffix-square sums W (_mis_tables): only the two junction factors
    (combo-specific pdfs) are evaluated per combo, cutting the traced
    elementwise op count of the 42-combo grid ~2x.  Algebraically equal
    to the sequential walk, kept as _mis_weight_walk and pinned by
    tests/test_mis.py::test_table_form_matches_walk.
    """
    s = eye.pos.shape[0]
    if tables is None:
        tables = _mis_tables(scene, eye, light,
                             consistent_camera=consistent_camera)
    w_inv = jnp.ones((s,))
    found, eol_point_pdf, eol_dir_pdf_fn = eye_on_light_pdfs

    def dbar(tab, i):
        return jnp.where(tab[i], 0.0, 1.0)

    # positions the junction-adjacent steps arrive from (the other
    # subpath's endpoint for this combo)
    if i_light >= 1:
        light_end_pos = (light_sample["pos"] if i_light == 1
                         else light.pos[:, i_light])
    eye_end_pos = (eye_sample["pos"] if i_eye == 1 else eye.pos[:, i_eye])

    # --- eye side: junction ratio + one junction-adjacent factor + W ------
    if i_eye >= 2:
        if i_light == 0:
            nomj = jnp.where(found, eol_point_pdf, jnp.nan)
        else:
            prev = light_sample if i_light == 1 else _vert(light, i_light)
            nomj = _junction_pg(scene, prev, light.pos[:, i_light - 1],
                                eye.pos[:, i_eye], eye.n[:, i_eye],
                                use_dir_pdf=(i_light == 1))
        r_e = nomj / jnp.maximum(tables["B_e"][i_eye], 1e-20)
        w_inv = w_inv + dbar(tables["D_e"], i_eye) * r_e * r_e
        if i_eye >= 3:
            i = i_eye - 1
            if i_light == 0:
                # the on-light vertex emits toward eye[i]: light dir pdf * G
                wi, dist = _seg(eye.pos[:, i + 1], eye.pos[:, i])
                g = jnp.abs(jnp.sum(wi * eye.n[:, i + 1], axis=-1)
                            * jnp.sum(wi * eye.n[:, i], axis=-1)) \
                    / jnp.maximum(dist * dist, 1e-12)
                nom2 = eol_dir_pdf_fn(wi) * g
            else:
                # alternative samples eye[i] from eye[i+1], which it
                # reached FROM the light-side endpoint of this combo
                nom2 = _pg(scene, eye.pos[:, i + 1], eye.n[:, i + 1],
                           eye.mat[:, i + 1], light_end_pos,
                           eye.pos[:, i], eye.n[:, i])
            c_e = r_e * nom2 / jnp.maximum(tables["B_e"][i], 1e-20)
            w_inv = w_inv + c_e * c_e * (dbar(tables["D_e"], i)
                                         + tables["W_e"][i_eye])

    # --- light side -------------------------------------------------------
    if i_light >= 1:
        prev = eye_sample if i_eye == 1 else _vert(eye, i_eye)
        if i_light == 1 and not t1_reference:
            # the t=1 path's light vertex IS the fresh sample; price it
            cur_pos, cur_n = light_sample["pos"], light_sample["n"]
            denj = light_sample["p"]
        else:
            cur_pos, cur_n = light.pos[:, i_light], light.n[:, i_light]
            denj = tables["B_l"][i_light]
        nomj = _junction_pg(scene, prev, eye.pos[:, i_eye - 1],
                            cur_pos, cur_n, use_dir_pdf=(i_eye <= 1))
        r_l = nomj / jnp.maximum(denj, 1e-20)
        w_inv = w_inv + dbar(tables["D_l"], i_light) * r_l * r_l
        if i_light >= 2:
            i = i_light - 1
            # alternative samples light[i] from light[i+1], reached FROM
            # the eye-side endpoint of this combo
            nom2 = _pg(scene, light.pos[:, i + 1], light.n[:, i + 1],
                       light.mat[:, i + 1], eye_end_pos,
                       light.pos[:, i], light.n[:, i])
            c_l = r_l * nom2 / jnp.maximum(tables["B_l"][i], 1e-20)
            w_inv = w_inv + c_l * c_l * (dbar(tables["D_l"], i)
                                         + tables["W_l"][i_light])

    w = 1.0 / w_inv
    if i_light == 0:
        w = jnp.where(found, w, 0.0)
    w = jnp.where(jnp.isfinite(w), w, 0.0)
    # MIS weights form a partition of unity for any fixed path; detach so
    # parameter gradients flow through contributions only.
    return jax.lax.stop_gradient(w)


def _mis_weight_walk(scene: Scene, i_eye: int, i_light: int,
                     eye: Subpath, light: Subpath,
                     light_sample: dict | None, eye_sample: dict | None,
                     eye_on_light_pdfs, tables: dict | None = None,
                     consistent_camera: bool = False,
                     t1_reference: bool = False):
    """The sequential pdf-ratio walk form of _mis_weight — the direct
    restructuring of the reference's loop (bidirection.cpp:121-293).
    Algebraically identical to the table form; kept as its oracle
    (tests/test_mis.py::test_table_form_matches_walk)."""
    s = eye.pos.shape[0]
    if tables is None:
        tables = _mis_tables(scene, eye, light,
                             consistent_camera=consistent_camera)
    w_inv = jnp.ones((s,))
    found, eol_point_pdf, eol_dir_pdf_fn = eye_on_light_pdfs

    if i_light >= 1:
        light_end_pos = (light_sample["pos"] if i_light == 1
                         else light.pos[:, i_light])
    eye_end_pos = (eye_sample["pos"] if i_eye == 1 else eye.pos[:, i_eye])

    # --- eye-path walk (i from i_eye down to 2) ---------------------------
    ratio = jnp.ones((s,))
    for i in range(i_eye, 1, -1):
        if i == i_eye:
            if i_light == 0:
                nom = jnp.where(found, eol_point_pdf, jnp.nan)
            else:
                prev = light_sample if i_light == 1 else _vert(light, i_light)
                nom = _junction_pg(scene, prev, light.pos[:, i_light - 1],
                                   eye.pos[:, i], eye.n[:, i],
                                   use_dir_pdf=(i_light == 1))
        elif i == i_eye - 1 and i_light == 0:
            wi, dist = _seg(eye.pos[:, i + 1], eye.pos[:, i])
            g = jnp.abs(jnp.sum(wi * eye.n[:, i + 1], axis=-1)
                        * jnp.sum(wi * eye.n[:, i], axis=-1)) \
                / jnp.maximum(dist * dist, 1e-12)
            nom = eol_dir_pdf_fn(wi) * g
        elif i == i_eye - 1:
            nom = _pg(scene, eye.pos[:, i + 1], eye.n[:, i + 1],
                      eye.mat[:, i + 1], light_end_pos,
                      eye.pos[:, i], eye.n[:, i])
        else:
            nom = tables["A_e"][i]
        ratio = ratio * nom / jnp.maximum(tables["B_e"][i], 1e-20)
        w_inv = w_inv + jnp.where(tables["D_e"][i], 0.0, ratio * ratio)

    # --- light-path walk (i from i_light down to 1) -----------------------
    ratio = jnp.ones((s,))
    for i in range(i_light, 0, -1):
        if i == i_light:
            prev = eye_sample if i_eye == 1 else _vert(eye, i_eye)
            if i_light == 1 and not t1_reference:
                cur_pos, cur_n = light_sample["pos"], light_sample["n"]
            else:
                cur_pos, cur_n = light.pos[:, i], light.n[:, i]
            nom = _junction_pg(scene, prev, eye.pos[:, i_eye - 1],
                               cur_pos, cur_n,
                               use_dir_pdf=(i_eye <= 1))
        elif i == i_light - 1:
            nom = _pg(scene, light.pos[:, i + 1], light.n[:, i + 1],
                      light.mat[:, i + 1], eye_end_pos,
                      light.pos[:, i], light.n[:, i])
        else:
            nom = tables["A_l"][i]
        if i == 1 and i_light == 1 and not t1_reference:
            denom = light_sample["p"]
        else:
            denom = tables["B_l"][i]
        ratio = ratio * nom / jnp.maximum(denom, 1e-20)
        w_inv = w_inv + jnp.where(tables["D_l"][i], 0.0, ratio * ratio)

    w = 1.0 / w_inv
    if i_light == 0:
        w = jnp.where(found, w, 0.0)
    w = jnp.where(jnp.isfinite(w), w, 0.0)
    return jax.lax.stop_gradient(w)


def _scene_bounds(scene: Scene):
    """(center [3], bounding radius) of the scene geometry, traced —
    masked reductions over the padded SoA arrays."""
    g = scene.geometry
    tv = g.tri_valid[:, None, None]
    lo_t = jnp.min(jnp.where(tv, g.tri_p, INF_D), axis=(0, 1))
    hi_t = jnp.max(jnp.where(tv, g.tri_p, -INF_D), axis=(0, 1))
    if g.num_spheres > 0:
        sv = g.sph_valid[:, None]
        lo_s = jnp.min(jnp.where(sv, g.sph_c - g.sph_r[:, None], INF_D),
                       axis=0)
        hi_s = jnp.max(jnp.where(sv, g.sph_c + g.sph_r[:, None], -INF_D),
                       axis=0)
        lo_t = jnp.minimum(lo_t, lo_s)
        hi_t = jnp.maximum(hi_t, hi_s)
    ctr = 0.5 * (lo_t + hi_t)
    rad = 0.5 * jnp.linalg.norm(hi_t - lo_t) * 1.05 + 1e-3
    return ctr, rad


def _pdf_area_from(dir_pdf, from_pos, to_pos, to_n):
    """Solid-angle pdf at from_pos -> area density at to_pos."""
    wi, dist = _seg(from_pos, to_pos)
    return dir_pdf * jnp.abs(jnp.sum(wi * to_n, axis=-1)) \
        / jnp.maximum(dist * dist, 1e-12)


def _pdf_area_edge(scene: Scene, path: Subpath, m: int, arrival,
                   target: int, arrival_w=None):
    """Area density of sampling path vertex `target` by BSDF-sampling at
    vertex m, having arrived at m from vertex `arrival` (or along
    arrival_w, a world direction from m TOWARD its arrival side)."""
    wi, dist = _seg(path.pos[:, m], path.pos[:, target])
    if arrival_w is None:
        wo, _ = _seg(path.pos[:, m], path.pos[:, arrival])
    else:
        wo = arrival_w
    p = _mis_pdf_local(scene, path.mat[:, m], wo, wi, path.n[:, m])
    return p * jnp.abs(jnp.sum(wi * path.n[:, target], axis=-1)) \
        / jnp.maximum(dist * dist, 1e-12)


def _env_subpath_splats(scene: Scene, keys, width: int, height: int,
                        nv: int, ctr, rad_b, pdf_pos, light_img,
                        inv_ns_aa, cfg: RenderConfig):
    """Strategy family (c): env emission subpaths connected to the camera
    as light-image splats, power-2-weighted against the eye-side env
    strategies of each path class — (b) env NEE at the env-adjacent
    vertex and (d) eye-walk BSDF-sampled miss pickup (see the env section
    of sample_pass).

    Returns (light_img with splats added, measured ray count)."""
    from bidirectional_pathtracing.ops import envlight
    from bidirectional_pathtracing.ops.intersect import (
        scene_occluded_segment as _socc)
    s = keys.shape[0]
    u4 = rng.uniform(rng.fold(keys, 5100), (4,))
    u2 = rng.uniform(rng.fold(keys, 5101), (2,))
    center = jnp.broadcast_to(ctr, (s, 3))
    rad, o, d, pp, dp = envlight.sample_Le(scene.envmap, center, rad_b,
                                           u4, u2)
    lp, _ = _prepare_subpath(scene, o, d, jnp.maximum(pp, 1e-12),
                             jnp.maximum(dp, 1e-12), rad, d, keys, 47, nv,
                             EPS_F, INF_D, adjoint=True)
    # path-density chains (the shared env dir_pdf cancels in the (b)/(c)
    # ratio; strategy (d) replaces it with the BSDF's directional pdf, so
    # its ratio carries the explicit B/E factor):
    #  p_c(t) = pdf_pos*|cos(n_w1, beam)| * prod pcL   (env-side order)
    #  p_b(t) = camdir*cos/d^2 * prod pbL              (camera-side order)
    #  p_d(t) = p_b-spatial-chain * B_w1/E_beam  (same chain as (b); the
    #           env-adjacent direction is BSDF-sampled, not env-sampled)
    pc_root = pdf_pos * jnp.abs(jnp.sum(lp.n[:, 2] * d, axis=-1))
    # delta env-adjacent vertex: (b) cannot sample (env NEE through a
    # delta is f=0) and (d)'s Dirac directional density dominates (c)'s
    # continuous one on the restricted manifold -> w_c = 0, w_d = 1
    # (sample_pass's delta_i rule carries the class).
    delta_w1 = _is_delta(scene, lp.mat[:, 2])
    e_beam = jnp.maximum(dp, 1e-12)
    # arrival wo at the env-adjacent vertex for t>=3 (only possible nv>=3)
    w1_to_w2 = (_seg(lp.pos[:, 2], lp.pos[:, 3])[0] if nv >= 3 else None)
    pcl = jnp.ones((s,))
    pblint = jnp.ones((s,))

    conns = []
    for t in range(2, nv + 1):
        vl_pos, vl_n = lp.pos[:, t], lp.n[:, t]
        ci = camera_ops.sample_ray_pdf(scene.camera, vl_pos, width, height)
        conn, dist = _seg(vl_pos, ci.point)
        o2w_l = make_coord_space(vl_n)
        light_ray, _ = _seg(vl_pos, lp.pos[:, t - 1])
        f_light = bsdf_ops.eval_f(scene.materials, lp.mat[:, t],
                                  to_local(o2w_l, conn),
                                  to_local(o2w_l, light_ray))
        g = jnp.abs(jnp.sum(vl_n * conn, axis=-1)
                    * jnp.sum(ci.normal * conn, axis=-1)) \
            / jnp.maximum(dist * dist, 1e-12)
        contrib = (ci.we / ci.point_pdf[:, None]) * lp.alpha[:, t] \
            * g[:, None] * f_light

        if t >= 3:
            # pcL: sampling v_t from v_{t-1}, arrived from env/v_{t-2}
            pcl = pcl * _pdf_area_edge(
                scene, lp, t - 1, t - 2 if t >= 4 else None, t,
                arrival_w=(-d if t == 3 else None))
            # pbL interior: sampling v_{t-2} from v_{t-1}, arrived v_t
            if t >= 4:
                pblint = pblint * _pdf_area_edge(scene, lp, t - 1, t,
                                                 t - 2)
            # the camera-adjacent sampled edge of strategy (b)
            pbl_t = _pdf_area_edge(scene, lp, t, None, t - 1,
                                   arrival_w=conn)
        else:
            pbl_t = jnp.ones((s,))
        cam_edge = _pdf_area_from(ci.dir_pdf, ci.point, vl_pos, vl_n)
        p_b = cam_edge * pblint * pbl_t
        p_c = pc_root * pcl
        r = p_b / jnp.maximum(p_c, 1e-30)
        # strategy (d) of this class: the eye walk reaches the
        # env-adjacent vertex (lp v2) through the same spatial chain as
        # (b) and BSDF-samples the env direction; p_d/p_c = r * B/E.  No
        # (d) strategy exists for the deepest class (the eye walk has no
        # step from vertex nv).
        if t < nv:
            wo_w1 = conn if t == 2 else w1_to_w2
            b_w1 = _mis_pdf_local(scene, lp.mat[:, 2], wo_w1, -d,
                                  lp.n[:, 2])
            r_d = r * b_w1 / e_beam
        else:
            r_d = jnp.zeros((s,))
        w_c = jnp.where(delta_w1, 0.0, 1.0 / (1.0 + r * r + r_d * r_d))
        w_c = jnp.where(jnp.isfinite(w_c), w_c, 0.0)

        valid = lp.valid[:, t] & ci.in_frame
        ill = jnp.where(valid[:, None], contrib * w_c[:, None], 0.0)
        ill = jnp.where(jnp.isfinite(ill), ill, 0.0)
        flat = jnp.clip(ci.py.astype(jnp.int32) * width
                        + ci.px.astype(jnp.int32), 0,
                        height * width - 1)
        conns.append((vl_pos, ci.point, valid, ill, flat))

    blk, _, _ = _socc(scene,
                      jnp.concatenate([c[0] for c in conns]),
                      jnp.concatenate([c[1] for c in conns]),
                      active=jnp.concatenate([c[2] for c in conns]))
    blk = blk.reshape(len(conns), s)
    for j, (_, _, valid, ill, flat) in enumerate(conns):
        ok = valid & ~blk[j]
        light_img = light_img.at[flat].add(
            jnp.where(ok[:, None], ill * inv_ns_aa, 0.0))
    rays = jnp.sum(jnp.concatenate(
        [c[2] for c in conns]).astype(jnp.float32))
    rays = rays + jnp.sum(lp.valid[:, 1:nv].astype(jnp.float32))
    return light_img, rays


def _eye_on_light_pdfs(scene: Scene, pos, prev_pos):
    """For the t=0 case: find the light containing the eye endpoint
    (bidirection.cpp:159-175, 307-328).  Returns (found, point_pdf,
    dir_pdf_fn, radiance_toward(prev))."""
    s = pos.shape[0]
    nl = light_ops.num_lights(scene.lights)
    found = jnp.zeros((s,), bool)
    point_pdf = jnp.zeros((s,))
    rad = jnp.zeros((s, 3))
    wi, _ = _seg(prev_pos, pos)  # direction toward the light point

    captured = []
    for li in range(nl):
        idx = jnp.full((s,), li, jnp.int32)
        contains = light_ops.contain_point(scene.lights, idx, pos)
        r_i, pp_i, dp_i = light_ops.sample_pdf(scene.lights, idx, pos, wi)
        new = contains & ~found
        point_pdf = jnp.where(new, pp_i, point_pdf)
        rad = jnp.where(new[..., None], r_i, rad)
        captured.append((new, idx))
        found = found | contains

    def dir_pdf_fn(w_world):
        """pdf of the light emitting along w_world from `pos`."""
        out = jnp.zeros((s,))
        for new, idx in captured:
            # sample_pdf expects wi pointing toward the light; pass -w.
            _, _, dp = light_ops.sample_pdf(scene.lights, idx, pos, -w_world)
            out = jnp.where(new, dp, out)
        return out

    return found, point_pdf, dir_pdf_fn, rad


def sample_pass(scene: Scene, key, width: int, height: int, pixel_ids,
                cfg: RenderConfig, return_stats: bool = False,
                inv_ns_aa=None):
    """One camera-sample-per-pixel BDPT pass.

    Returns (eye_L [S,3], light_img [H*W,3]).  light_img carries the
    1/ns_aa factor like the reference's splats (bidirection.cpp:460-461).
    inv_ns_aa: optional TRACED 1/spp scalar for the splat normalisation —
    passing it as an operand (rather than baking cfg.spp into the trace)
    lets one compiled step serve every spp (utils/render.py _trace_cfg).

    With return_stats, also returns a dict with "rays": the MEASURED count
    of intersection queries an equivalent per-ray tracer would issue (the
    reference's total_rays counter, bvh.h:136): walk launches gated by the
    per-lane alive masks plus connection shadow segments gated by endpoint
    validity.  (The wavefront hardware launches every lane every step; that
    static count is width*height agnostic and reported by the driver.)
    """
    s = pixel_ids.shape[0]
    nv = cfg.max_ray_depth + 1           # real vertices per subpath
    nl_lights = light_ops.num_lights(scene.lights)
    if inv_ns_aa is None:
        inv_ns_aa = jnp.float32(1.0 / cfg.spp)

    # per-lane counter-based keys from GLOBAL pixel ids: bitwise identical
    # under any sharding of the pixel axis
    keys = rng.lane_keys(key, pixel_ids)

    # --- eye subpath ------------------------------------------------------
    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)
    u = rng.uniform(rng.fold(keys, 1), (2,))
    o, d = camera_ops.generate_ray(
        scene.camera, (px + u[:, 0]) / width, (py + u[:, 1]) / height)
    eye, (eye_step_d, eye_step_miss) = _prepare_subpath(
        scene, o, d, jnp.ones((s,)), jnp.ones((s,)), jnp.ones((s, 3)),
        d, keys, 10, nv, scene.camera.nclip, scene.camera.fclip)

    # --- light subpath (sample_light_ray, bidirection.cpp:105-118) --------
    if nl_lights > 0:
        lidx = rng.randint(rng.fold(keys, 3), nl_lights)
        le = light_ops.sample_Le(scene.lights, lidx,
                                 rng.uniform(rng.fold(keys, 4), (2,)),
                                 rng.uniform(rng.fold(keys, 5), (2,)))
        point_pdf = le.point_pdf / nl_lights
        light, _ = _prepare_subpath(
            scene, le.o, le.d, jnp.maximum(point_pdf, 1e-12), le.dir_pdf,
            le.radiance, le.normal, keys, 40, nv, EPS_F, INF_D,
            adjoint=True)
        light_valid_root = le.point_pdf > 0
        light = light._replace(
            valid=light.valid & light_valid_root[:, None])
    else:
        light = None

    eye_L = jnp.zeros((s, 3))
    light_img = jnp.zeros((height * width, 3))

    # --- environment light (EXTENSION: the reference BDPT asserts on env
    # lights, environment_light.cpp:182-208).  Strategy families:
    #   (a) env radiance on the PRIMARY miss (pathtracer.cpp:271-272) —
    #       the only sampler of the 0-surface-vertex class, weight 1;
    #   (b) env NEE at every non-delta eye vertex;
    #   (c) ENV LIGHT SUBPATHS: emission rays sampled via
    #       envlight.sample_Le (CDF direction x disk origin, the pbrt
    #       parallel-beam conventions), walked like any light subpath and
    #       connected to the camera as light-image splats;
    #   (d) eye-walk MISS pickup: when a BSDF-sampled walk step leaves the
    #       scene, the env radiance along it is collected — the only
    #       sampler able to reach env through ALL-DELTA chains (mirror /
    #       glass showing the sky), which neither (b) (NEE at a delta is
    #       f=0) nor (c) (camera connection through a delta is f=0) can.
    # A path class with k>=1 surface vertices is sampled by (b) at its
    # env-adjacent vertex, (c) with a k-vertex subpath, and (d) at the
    # k-th walk step, so the three carry power-2 MIS weights computed
    # from the full path densities; classes whose env-adjacent vertex is
    # delta belong to (d) alone (its Dirac directional density dominates
    # (c)'s continuous one on the restricted manifold), and the deepest
    # class (env-adjacent at vertex nv) has no (d) sampler, so its (b)/(c)
    # weights drop the p_d term.  The partition is complete and the
    # converged BDPT render equals the pt_mis PT's (which adds the
    # matching env pickup, models/pathtracer.py) — tests/test_env_bdpt.py.
    # MIXED env+area scenes: the env families run UNCONDITIONALLY (their
    # own dedicated subpath walk, selection probability 1 — the env does
    # NOT join the area-light pick, so no selection pdf enters the
    # densities).  Env-emission paths and area/point-light paths are
    # DISJOINT path-space supports (a complete path includes its emitter:
    # x_0 at infinity vs x_0 on a light surface), so (b)/(c)/(d) form the
    # complete strategy set for every env path class and the area-light
    # (s,t) families keep their own MIS untouched
    # (tests/test_env_bdpt.py::test_bdpt_env_mixed_matches_pt). ----------
    env_rays = jnp.float32(0)
    if scene.envmap is not None:
        from bidirectional_pathtracing.ops import envlight
        from bidirectional_pathtracing.ops.intersect import (
            scene_occluded)
        ctr, rad_b = _scene_bounds(scene)
        pdf_pos = 1.0 / (jnp.pi * rad_b * rad_b)
        if nv >= 2:
            d1 = eye.n[:, 1]             # camera ray dir (walk init normal)
            miss1 = ~eye.valid[:, 2]
            eye_L += jnp.where(miss1[:, None],
                               envlight.sample_dir(scene.envmap, d1), 0.0)
        # (b) env NEE + (d) walk-miss pickup, weighted vs each other and
        # the (c) splat strategy of each class
        o_all, d_all, c_all, a_all = [], [], [], []
        pb_cum = jnp.ones((s,))          # camera-side pdf chain (area)
        pc_int = jnp.ones((s,))          # env-side interior pdf chain
        # strategy (c) connects the path's camera-adjacent vertex (v2) to
        # the camera explicitly; a delta v2 makes that connection f=0, so
        # the p_c terms drop out of the (b) and (d) weights there (Veach
        # delta-skip — the symmetric gate to delta_w1 in
        # _env_subpath_splats)
        delta_cam = _is_delta(scene, eye.mat[:, 2])
        for i in range(2, nv + 1):
            vi_valid = eye.valid[:, i] & ~_is_delta(scene, eye.mat[:, i])
            u4 = rng.uniform(rng.fold(keys, 5000 + i * 13), (4,))
            rad, wi_w, _dist, pdf = envlight.sample_L(
                scene.envmap, eye.pos[:, i], u4)
            pdf = jnp.maximum(pdf, 1e-12)
            o2w = make_coord_space(eye.n[:, i])
            wo_w, _ = _seg(eye.pos[:, i], eye.pos[:, i - 1])
            f = bsdf_ops.eval_f(scene.materials, eye.mat[:, i],
                                to_local(o2w, wo_w), to_local(o2w, wi_w))
            cos = jnp.abs(jnp.sum(wi_w * eye.n[:, i], axis=-1))
            contrib = (eye.alpha[:, i] * rad * f * (cos / pdf)[:, None])
            if i == 2:
                ci0 = camera_ops.sample_ray_pdf(scene.camera,
                                                eye.pos[:, 2], 1, 1)
                pb_cum = _pdf_area_from(
                    ci0.dir_pdf, eye.pos[:, 1], eye.pos[:, 2],
                    eye.n[:, 2])
            else:
                # extend chains camera->v_i / env-interior to v_{i-1}
                pb_cum = pb_cum * _pdf_area_edge(
                    scene, eye, i - 1, i - 2, i)
                if i >= 4:
                    pc_int = pc_int * _pdf_area_edge(
                        scene, eye, i - 1, i, i - 2)

            def _r_vs_c(env_dir, cos_i):
                # p_c/p_b-chain ratio for the class whose env-adjacent
                # edge leaves v_i along env_dir (area measures; the env
                # directional pdf is NOT included — it cancels against
                # (b)'s or is priced explicitly by (d))
                pc_env = pdf_pos * cos_i
                if i >= 3:
                    pc_env = pc_env * _pdf_area_edge(
                        scene, eye, i, None, i - 1, arrival_w=env_dir)
                rv = pc_env * pc_int / jnp.maximum(pb_cum, 1e-30)
                return jnp.where(delta_cam, 0.0, rv)

            # (b): compete with (c) [r_cb] and (d) [r_db = B/E];
            # the deepest class has no (d) sampler
            r_cb = _r_vs_c(wi_w, cos)
            if i < nv:
                b_nee = bsdf_ops.mis_pdf(scene.materials, eye.mat[:, i],
                                         to_local(o2w, wo_w),
                                         to_local(o2w, wi_w))
                r_db = b_nee / pdf
            else:
                r_db = jnp.zeros((s,))
            w_b = 1.0 / (1.0 + r_cb * r_cb + r_db * r_db)
            if _ENV_STRATEGY == "nee":
                w_b = jnp.ones_like(w_b)
            contrib = contrib * w_b[:, None]
            o_all.append(eye.pos[:, i])
            d_all.append(wi_w)
            c_all.append(jnp.where(vi_valid[:, None], contrib, 0.0))
            a_all.append(vi_valid)

            # (d): the walk step FROM v_i (producing v_{i+1}) missed the
            # scene — collect env radiance along it.  alpha at the
            # would-be vertex i+1 is valid on misses (see
            # _prepare_subpath); no extra rays are cast.
            if i < nv and _ENV_STRATEGY != "nee":
                d_m = eye_step_d[:, i - 1]
                miss_m = eye_step_miss[:, i - 1] & eye.valid[:, i]
                rad_d = envlight.sample_dir(scene.envmap, d_m)
                contrib_d = eye.alpha[:, i + 1] * rad_d
                delta_i = _is_delta(scene, eye.mat[:, i])
                e_d = jnp.maximum(envlight.pdf_dir(scene.envmap, d_m),
                                  1e-12)
                b_d = jnp.maximum(
                    bsdf_ops.mis_pdf(scene.materials, eye.mat[:, i],
                                     to_local(o2w, wo_w),
                                     to_local(o2w, d_m)), 1e-12)
                r_b = e_d / b_d                       # p_b/p_d
                cos_d = jnp.abs(jnp.sum(d_m * eye.n[:, i], axis=-1))
                r_c = _r_vs_c(d_m, cos_d) * r_b       # p_c/p_d
                w_d = jnp.where(delta_i, 1.0,
                                1.0 / (1.0 + r_b * r_b + r_c * r_c))
                ill_d = jnp.where(
                    miss_m[:, None],
                    jnp.where(jnp.isfinite(contrib_d), contrib_d, 0.0)
                    * w_d[:, None], 0.0)
                eye_L += jnp.where(jnp.isfinite(ill_d), ill_d, 0.0)
        if o_all:
            act = jnp.concatenate(a_all)
            blocked = scene_occluded(
                scene, jnp.concatenate(o_all), jnp.concatenate(d_all),
                EPS_F, jnp.where(act, INF_D, -1.0))
            blocked = blocked.reshape(len(o_all), s)
            for j, c in enumerate(c_all):
                eye_L += jnp.where(blocked[j][:, None], 0.0, c)
            env_rays = jnp.sum(act.astype(jnp.float32))
        # (c) env light subpaths -> camera splats
        if nv >= 2 and _ENV_STRATEGY != "nee":
            light_img, c_rays = _env_subpath_splats(
                scene, keys, width, height, nv, ctr, rad_b, pdf_pos,
                light_img, inv_ns_aa, cfg)
            env_rays = env_rays + c_rays

    # --- connections: i_eye in 1..nv, i_light in 0..nv --------------------
    # batch every combo's shadow segments into ONE occlusion launch
    combos = [(i_e, i_l) for i_e in range(1, nv + 1)
              for i_l in range(0, (nv + 1) if light is not None else 1)]
    seg_combos = [c for c in combos if c[1] >= 1]

    def _pair_valid(i_e, i_l):
        pv = eye.valid[:, i_e]
        if i_l == 1:
            a = eye.pos[:, 1] if i_e == 1 else eye.pos[:, i_e]
            return pv & _fresh_light_point(scene, i_e, a, keys,
                                           nl_lights)["valid"]
        return pv & light.valid[:, i_l]

    blocked_by_combo = {}
    if seg_combos:
        a_all, b_all, pv_all = [], [], []
        for (i_e, i_l) in seg_combos:
            a, b = _connection_endpoints(scene, i_e, i_l, eye, light, keys)
            a_all.append(a)
            b_all.append(b)
            pv_all.append(_pair_valid(i_e, i_l))
        from bidirectional_pathtracing.ops.intersect import (
            scene_occluded_segment as _socc)
        # invalid pairs get an empty t-window: their contributions are
        # masked to zero anyway, and the any-hit kernel counts them as
        # done (dead-lane pruning)
        blk, _, _ = _socc(scene, jnp.concatenate(a_all),
                          jnp.concatenate(b_all),
                          active=jnp.concatenate(pv_all))
        blk = blk.reshape(len(seg_combos), s)
        blocked_by_combo = {c: blk[i] for i, c in enumerate(seg_combos)}

    mis_tables = _mis_tables(scene, eye, light,
                             consistent_camera=cfg.bdpt_consistent_camera)
    for (i_eye, i_light) in combos:
            ill, splat_xy, splat_mask = _estimate_radiance(
                scene, i_eye, i_light, eye, light, keys,
                width, height, cfg,
                blocked=blocked_by_combo.get((i_eye, i_light)),
                tables=mis_tables)
            if i_eye == 1:
                if splat_xy is not None:
                    flat = (splat_xy[:, 1] * width + splat_xy[:, 0])
                    flat = jnp.clip(flat, 0, height * width - 1)
                    light_img = light_img.at[flat].add(
                        jnp.where(splat_mask[:, None], ill * inv_ns_aa, 0.0))
            else:
                eye_L = eye_L + ill
    if not return_stats:
        return eye_L, light_img

    # measured rays: walk launch i is live for lanes valid at vertex i
    rays = jnp.sum(eye.valid[:, 1:nv].astype(jnp.float32)) + env_rays
    if light is not None:
        rays += jnp.sum(light.valid[:, 1:nv].astype(jnp.float32))
    for (i_e, i_l) in seg_combos:
        rays += jnp.sum(_pair_valid(i_e, i_l).astype(jnp.float32))
    return eye_L, light_img, {"rays": rays}


def _fresh_light_point(scene: Scene, i_eye: int, eye_pos, keys, nl_lights):
    """The t=1 fresh light sample (bidirection.cpp:332-358), drawn from
    the combo's fixed RNG site — pure, so recomputation is CSE'd."""
    s = eye_pos.shape[0]
    site = 1000 + i_eye * 8
    lidx2 = rng.randint(rng.fold(keys, site), nl_lights)
    lp = light_ops.sample_Le_point(
        scene.lights, lidx2, eye_pos,
        rng.uniform(rng.fold(keys, site + 1), (2,)))
    pp = jnp.maximum(lp.point_pdf / nl_lights, 1e-12)
    return dict(pos=lp.point, n=lp.normal, alpha=lp.radiance / pp[:, None],
                p=pp, mat=jnp.full((s,), -1, jnp.int32),
                valid=lp.point_pdf > 0, dir_pdf=lp.dir_pdf)


def _connection_endpoints(scene: Scene, i_eye: int, i_light: int,
                          eye: Subpath, light: Subpath, keys):
    """(a, b) segment endpoints for a combo with i_light >= 1."""
    nl_lights = light_ops.num_lights(scene.lights)
    a = eye.pos[:, 1] if i_eye == 1 else eye.pos[:, i_eye]
    if i_light == 1:
        b = _fresh_light_point(scene, i_eye, a, keys, nl_lights)["pos"]
    else:
        b = light.pos[:, i_light]
    return a, b


def _estimate_radiance(scene: Scene, i_eye: int, i_light: int,
                       eye: Subpath, light: Subpath | None, keys,
                       width: int, height: int, cfg: RenderConfig,
                       debug_inject: dict | None = None,
                       blocked=None, tables: dict | None = None):
    """estimate_bidirection_radiance for one (i_eye, i_light) combo.

    Returns (ill [S,3], splat_xy int [S,2] | None, splat_mask [S] | None).
    debug_inject optionally supplies pre-drawn "light_sample"/"eye_sample"
    dicts (used by the oracle path-replay tests to bypass RNG).
    blocked: optional precomputed visibility for this combo's segments
    (sample_pass batches all combos' shadow rays into one kernel launch).
    """
    s = eye.pos.shape[0]
    nl_lights = light_ops.num_lights(scene.lights) if light is not None else 0
    ve = _vert(eye, i_eye)
    light_sample = None
    eye_sample = None
    splat_xy = None
    splat_mask = None

    eol = None
    if i_light == 0:
        # t=0: eye path hit a light source
        if i_eye <= 1:
            return jnp.zeros((s, 3)), None, None
        eol = _eye_on_light_pdfs(scene, ve["pos"], eye.pos[:, i_eye - 1])
        found, _, _, rad = eol
        emit = bsdf_ops.emission(scene.materials, ve["mat"])
        emit_big = jnp.linalg.norm(emit, axis=-1) > EPS_F
        c = jnp.where(emit_big[:, None],
                      jnp.where(found[:, None], rad, 0.0), emit)
        pair_valid = ve["valid"]
        vl_alpha = jnp.ones((s, 3))
    else:
        vl = _vert(light, i_light)
        if i_light == 1:
            if debug_inject is not None and "light_sample" in debug_inject:
                light_sample = debug_inject["light_sample"]
            else:
                light_sample = _fresh_light_point(scene, i_eye, ve["pos"],
                                                  keys, nl_lights)
            vl = light_sample
        if i_eye == 1:
            # light path connects to the camera: light-image splat
            ci = camera_ops.sample_ray_pdf(scene.camera, vl["pos"],
                                           width, height)
            eye_sample = dict(
                pos=ci.point, n=ci.normal, alpha=ci.we / ci.point_pdf[:, None],
                p=ci.point_pdf, mat=jnp.full((s,), -1, jnp.int32),
                valid=jnp.ones((s,), bool), dir_pdf=ci.dir_pdf)
            ve = eye_sample
            splat_xy = jnp.stack([ci.px.astype(jnp.int32),
                                  ci.py.astype(jnp.int32)], axis=-1)
            splat_mask = ci.in_frame
            f_eye = jnp.ones((s, 3))
        else:
            o2w_e = make_coord_space(ve["n"])
            eye_ray, _ = _seg(ve["pos"], eye.pos[:, i_eye - 1])
            conn_e, _ = _seg(ve["pos"], vl["pos"])
            f_eye = bsdf_ops.eval_f(scene.materials, ve["mat"],
                                    to_local(o2w_e, eye_ray),
                                    to_local(o2w_e, conn_e))
        if i_light > 1:
            o2w_l = make_coord_space(vl["n"])
            light_ray, _ = _seg(vl["pos"], light.pos[:, i_light - 1])
            conn_l, _ = _seg(vl["pos"], ve["pos"])
            f_light = bsdf_ops.eval_f(scene.materials, vl["mat"],
                                      to_local(o2w_l, conn_l),
                                      to_local(o2w_l, light_ray))
        else:
            f_light = jnp.ones((s, 3))

        if blocked is None:
            blocked, conn, dist = scene_occluded_segment(scene, ve["pos"],
                                                         vl["pos"])
        else:
            conn, dist = _seg(ve["pos"], vl["pos"])
        g = jnp.abs(jnp.sum(vl["n"] * conn, axis=-1)
                    * jnp.sum(ve["n"] * conn, axis=-1)) \
            / jnp.maximum(dist * dist, 1e-12)
        c = jnp.where(blocked[:, None], 0.0, f_eye * g[:, None] * f_light)
        pair_valid = ve["valid"] & vl["valid"]
        vl_alpha = vl["alpha"]

    eye_alpha = ve["alpha"]
    contrib = eye_alpha * vl_alpha * c
    contrib = jnp.where(pair_valid[:, None], contrib, 0.0)
    big = jnp.linalg.norm(contrib, axis=-1) > EPS_F

    w = _mis_weight(scene, i_eye, i_light, eye, light, light_sample,
                    eye_sample,
                    (eol[0], eol[1], eol[2]) if eol is not None
                    else (jnp.zeros((s,), bool), jnp.zeros((s,)),
                          lambda _: jnp.zeros((s,))),
                    tables=tables,
                    consistent_camera=cfg.bdpt_consistent_camera,
                    t1_reference=cfg.bdpt_reference_t1_mis)
    ill = jnp.where(big[:, None], contrib * w[:, None], 0.0)
    ill = jnp.where(jnp.isfinite(ill), ill, 0.0)
    return ill, splat_xy, splat_mask
