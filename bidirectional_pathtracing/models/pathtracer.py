"""Unidirectional path tracer with next-event estimation (wavefront).

Port of the *semantics* of the reference PathTracer
(reference src/pathtracer/pathtracer.cpp) to a fixed-shape lax.scan
wavefront: the recursive at_least_one_bounce_radiance (pathtracer.cpp:190-255)
becomes a bounce loop over a [S]-sample wavefront with active masks.

Reference behaviors preserved:
  - zero-bounce emission at the primary hit (pathtracer.cpp:167-174,275)
  - per-light NEE with ns_area_light samples and shadow rays
    (estimate_direct_lighting_importance, pathtracer.cpp:102-165), skipped
    at delta vertices (pathtracer.cpp:206)
  - emission re-added after delta bounces, since NEE cannot see deltas
    (pathtracer.cpp:240-242)
  - depth cap max_ray_depth; Russian roulette mode when max_ray_depth == 0
    (continue-prob 0.3, hard cap 20; pathtracer.cpp:211-222)
  - optional hemisphere direct sampling (-H; pathtracer.cpp:47-100)
  - environment light on primary miss (pathtracer.cpp:271-272); secondary
    misses terminate without env contribution, as in the reference
  - thin-lens camera rays (raytrace_pixel uses generate_ray_for_thin_lens,
    pathtracer.cpp:311-312)
  - adaptive sampling with the 95% CI rule (pathtracer.cpp:301-333) is
    implemented in the renderer driver (utils/render.py), not here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.core.math import (
    EPS_F, INF_D, make_coord_space, to_local, to_world, normalize,
)
from bidirectional_pathtracing.core import rng, samplers
from bidirectional_pathtracing.ops import bsdf as bsdf_ops
from bidirectional_pathtracing.ops import lights as light_ops
from bidirectional_pathtracing.ops import camera_ops
from bidirectional_pathtracing.ops.intersect import (
    scene_intersect, scene_occluded)
from bidirectional_pathtracing.scene.types import Scene


def _nee(scene: Scene, hit_p, hit_n, w_out_w, mid, keys, cfg: RenderConfig,
         mis: bool = False):
    """estimate_direct_lighting_importance for a wavefront.

    Averages cfg.light_samples NEE samples per light and sums over lights
    (pathtracer.cpp:121-156).  Delta lights are deterministic so averaging
    identical samples reproduces the reference's single-sample rule.
    keys: per-lane PRNG keys [S].

    mis=True (cfg.pt_mis interior vertices): area-light samples carry the
    power-2 weight against the BSDF-sampling strategy that could reach the
    same emissive surface (the complementary weight is applied to the
    BSDF-sampled emission pickup in trace_radiance); non-area lights are
    NEE-only strategies and keep weight 1.
    """
    from bidirectional_pathtracing.scene.types import LIGHT_AREA
    nl = light_ops.num_lights(scene.lights)
    if nl == 0 and scene.envmap is None:
        return jnp.zeros_like(hit_p)
    o2w = make_coord_space(hit_n)
    w_out = to_local(o2w, w_out_w)
    total = jnp.zeros_like(hit_p)
    for li in range(nl):
        acc = jnp.zeros_like(hit_p)
        for si in range(cfg.light_samples):
            u2 = rng.uniform(rng.fold(keys, 7000 + li * 97 + si), (2,))
            idx = jnp.full(hit_p.shape[:-1], li, jnp.int32)
            s = light_ops.sample_L(scene.lights, idx, hit_p, u2,
                                   reference_quirks=cfg.pt_reference_nee)
            wi = to_local(o2w, s.wi)
            f = bsdf_ops.eval_f(scene.materials, mid, w_out, wi)
            # relative far-end margin (see ops.intersect.occluded_segment)
            max_t = jnp.where(s.dist >= INF_D, INF_D,
                              s.dist * (1.0 - 2e-4) - EPS_F)
            blocked = scene_occluded(scene, hit_p, s.wi, EPS_F, max_t)
            cos = jnp.abs(jnp.sum(s.wi * hit_n, axis=-1))
            contrib = (s.radiance * f * (cos / jnp.maximum(s.pdf, 1e-12))[..., None])
            if mis:
                pdf_b = bsdf_ops.mis_pdf(scene.materials, mid, w_out, wi)
                w = s.pdf * s.pdf / jnp.maximum(
                    s.pdf * s.pdf + pdf_b * pdf_b, 1e-20)
                is_area = scene.lights.kind[li] == LIGHT_AREA
                contrib = contrib * jnp.where(is_area, w, 1.0)[..., None]
            acc += jnp.where(blocked[..., None], 0.0, contrib)
        total += acc / cfg.light_samples

    # Environment light: the reference appends it to scene->lights when -e
    # is given (raytraced_renderer.cpp:117-119), so NEE samples it like any
    # other light via its CDF importance sampler.
    if scene.envmap is not None:
        from bidirectional_pathtracing.ops import envlight
        acc = jnp.zeros_like(hit_p)
        for si in range(cfg.light_samples):
            u4 = rng.uniform(rng.fold(keys, 7500 + si), (4,))
            rad, wi_w, dist, pdf = envlight.sample_L(scene.envmap, hit_p, u4)
            wi = to_local(o2w, wi_w)
            f = bsdf_ops.eval_f(scene.materials, mid, w_out, wi)
            blocked = scene_occluded(scene, hit_p, wi_w, EPS_F, INF_D)
            cos = jnp.abs(jnp.sum(wi_w * hit_n, axis=-1))
            contrib = rad * f * (cos / jnp.maximum(pdf, 1e-12))[..., None]
            if mis:
                # power-2 weight vs the BSDF-sampled env pickup
                # (trace_radiance's bounce-miss collection) of the same
                # path class
                pdf_b = bsdf_ops.mis_pdf(scene.materials, mid, w_out, wi)
                w = pdf * pdf / jnp.maximum(pdf * pdf + pdf_b * pdf_b,
                                            1e-20)
                contrib = contrib * w[..., None]
            acc += jnp.where(blocked[..., None], 0.0, contrib)
        total += acc / cfg.light_samples
    return total


def _nee_pdf_toward_hit(scene: Scene, wi_w, t, p_hit, cfg: RenderConfig):
    """Solid-angle pdf with which _nee (same quirk configuration) would
    have generated direction wi_w, given a BSDF-sampled ray hit the point
    p_hit at distance t.  Returns (pdf, on_back): pdf is 0 when the hit
    lies on no area light (then BSDF sampling is the only strategy);
    on_back marks back-side hits of an area light, whose NEE radiance is
    defined 0 (light.cpp:216 cos test) so the pickup is suppressed to
    keep both strategies integrating the same function."""
    from bidirectional_pathtracing.scene.types import LIGHT_AREA
    lights = scene.lights
    nl = light_ops.num_lights(lights)
    s = wi_w.shape[:-1]
    pdf = jnp.zeros(s)
    on_back = jnp.zeros(s, bool)
    found = jnp.zeros(s, bool)
    sq = t * t
    for li in range(nl):
        idx = jnp.full(s, li, jnp.int32)
        contains = light_ops.contain_point(lights, idx, p_hit)
        is_area = lights.kind[li] == LIGHT_AREA
        cos_l = jnp.sum(wi_w * lights.direction[li], axis=-1)
        area = lights.area[li]
        if cfg.pt_reference_nee:
            pdf_li = sq / jnp.maximum(
                area * jnp.abs(cos_l) * jnp.maximum(t, 1e-10), 1e-12)
        else:
            pdf_li = sq / jnp.maximum(area * jnp.abs(cos_l), 1e-12)
        new = contains & is_area & ~found
        pdf = jnp.where(new, pdf_li, pdf)
        on_back = on_back | (new & (cos_l >= 0))
        found = found | (contains & is_area)
    return pdf, on_back


def _nee_hemisphere(scene: Scene, hit_p, hit_n, w_out_w, mid, keys,
                    cfg: RenderConfig):
    """estimate_direct_lighting_hemisphere (pathtracer.cpp:47-100):
    sample the BSDF, trace, and collect emission of whatever is hit."""
    nl = max(light_ops.num_lights(scene.lights), 1)
    n_samples = nl * cfg.light_samples
    o2w = make_coord_space(hit_n)
    w_out = to_local(o2w, w_out_w)
    acc = jnp.zeros_like(hit_p)
    for i in range(n_samples):
        u3 = rng.uniform(rng.fold(keys, 8000 + i), (3,))
        bs = bsdf_ops.sample(scene.materials, mid, w_out, u3)
        wi_w = normalize(to_world(o2w, bs.wi))
        h = scene_intersect(scene, hit_p, wi_w, EPS_F, INF_D)
        emit = bsdf_ops.emission(scene.materials, h.mat)
        cos = jnp.abs(jnp.sum(wi_w * hit_n, axis=-1))
        contrib = emit * bs.f * (cos / bs.pdf)[..., None]
        acc += jnp.where(h.valid[..., None], contrib, 0.0)
    return acc / n_samples


def trace_radiance(scene: Scene, o, d, keys, cfg: RenderConfig,
                   return_stats: bool = False):
    """est_radiance_global_illumination for a wavefront of camera rays.

    o, d: [S,3]; keys: per-lane PRNG keys [S].  Returns L [S,3] (and, with
    return_stats, a dict with "rays": the MEASURED per-ray query count the
    reference's total_rays counter would report, bvh.h:136 — primary +
    per-bounce continuations and NEE shadow rays gated by live masks).
    """
    rr = cfg.max_ray_depth == 0
    n_bounces = cfg.rr_depth_cap if rr else max(cfg.max_ray_depth - 1, 0)
    nl_shadow = light_ops.num_lights(scene.lights) * cfg.light_samples
    if scene.envmap is not None:
        nl_shadow += cfg.light_samples
    s_count = o.shape[0]

    hit = scene_intersect(scene, o, d, scene.camera.nclip,
                          scene.camera.fclip)
    rays = jnp.float32(s_count)
    L = jnp.zeros_like(o)
    if scene.envmap is not None:
        from bidirectional_pathtracing.ops import envlight
        env = envlight.sample_dir(scene.envmap, d)
        L += jnp.where(hit.valid[..., None], 0.0, env)
    # zero bounce (pathtracer.cpp:275)
    L += jnp.where(hit.valid[..., None],
                   bsdf_ops.emission(scene.materials, hit.mat), 0.0)

    throughput = jnp.ones_like(o)
    alive = hit.valid
    hit_p = o + hit.t[..., None] * d
    ray_d = d

    def bounce(carry, b):
        L, throughput, alive, hit_p, ray_d, hit_n, mid, rays = carry
        kb = rng.fold(keys, 100 + b)   # b is a traced scan index; rng.fold
                                       # accepts traced site constants

        delta = bsdf_ops.is_delta(scene.materials, mid)
        if cfg.direct_hemisphere_sample:
            direct = _nee_hemisphere(scene, hit_p, hit_n, -ray_d, mid,
                                     kb, cfg)
        else:
            direct = _nee(scene, hit_p, hit_n, -ray_d, mid, kb, cfg,
                          mis=cfg.pt_mis)
        L += jnp.where((alive & ~delta)[..., None], throughput * direct, 0.0)
        rays += jnp.sum((alive & ~delta).astype(jnp.float32)) * nl_shadow

        # continuation (pathtracer.cpp:211-238)
        cont = alive
        rr_scale = 1.0
        if rr:
            keep = rng.uniform(rng.fold(kb, 5)) < cfg.rr_cpdf
            cont = cont & keep
            rr_scale = 1.0 / cfg.rr_cpdf
        o2w = make_coord_space(hit_n)
        w_out = to_local(o2w, -ray_d)
        bs = bsdf_ops.sample(scene.materials, mid, w_out,
                             rng.uniform(rng.fold(kb, 6), (3,)))
        wi_w = normalize(to_world(o2w, bs.wi))
        nxt = scene_intersect(scene, hit_p, wi_w, EPS_F, INF_D)
        rays += jnp.sum(cont.astype(jnp.float32))
        cos = jnp.abs(jnp.sum(wi_w * hit_n, axis=-1))
        weight = bs.f * (cos / bs.pdf)[..., None] * rr_scale

        # delta vertices add the child emission (pathtracer.cpp:240-242);
        # pt_mis extends the pickup to ALL vertices with the power-2
        # complement of the NEE weight (delta keeps weight 1: NEE cannot
        # see deltas, so BSDF sampling is the only strategy there)
        child_emit = bsdf_ops.emission(scene.materials, nxt.mat)
        if cfg.pt_mis and not cfg.direct_hemisphere_sample:
            p_hit = hit_p + nxt.t[..., None] * wi_w
            pdf_l, on_back = _nee_pdf_toward_hit(scene, wi_w, nxt.t,
                                                 p_hit, cfg)
            w_b = bs.pdf * bs.pdf / jnp.maximum(
                bs.pdf * bs.pdf + pdf_l * pdf_l, 1e-20)
            w_b = jnp.where(delta, 1.0, jnp.where(on_back, 0.0, w_b))
            L += jnp.where((cont & nxt.valid)[..., None],
                           throughput * weight * child_emit
                           * w_b[..., None], 0.0)
        else:
            L += jnp.where((cont & nxt.valid & delta)[..., None],
                           throughput * weight * child_emit, 0.0)

        # pt_mis EXTENSION: env radiance pickup on bounce-ray misses,
        # power-2-weighted against the env NEE of the same path class
        # (delta vertices keep weight 1 — NEE cannot see them).  This is
        # the only PT strategy that reaches env through specular chains;
        # the reference-parity default (pt_mis=False) terminates secondary
        # misses black like the reference recursion (pathtracer.cpp:
        # 190-255), and BDPT's env strategy (d) is the bidirectional
        # counterpart (models/bdpt.py).
        if (scene.envmap is not None and cfg.pt_mis
                and not cfg.direct_hemisphere_sample):
            from bidirectional_pathtracing.ops import envlight
            env_rad = envlight.sample_dir(scene.envmap, wi_w)
            pdf_e = envlight.pdf_dir(scene.envmap, wi_w)
            w_e = bs.pdf * bs.pdf / jnp.maximum(
                bs.pdf * bs.pdf + pdf_e * pdf_e, 1e-20)
            w_e = jnp.where(delta, 1.0, w_e)
            L += jnp.where((cont & ~nxt.valid)[..., None],
                           throughput * weight * env_rad
                           * w_e[..., None], 0.0)

        throughput = jnp.where(cont[..., None], throughput * weight,
                               throughput)
        alive = cont & nxt.valid
        hit_p = jnp.where(alive[..., None],
                          hit_p + nxt.t[..., None] * wi_w, hit_p)
        ray_d = jnp.where(alive[..., None], wi_w, ray_d)
        hit_n = jnp.where(alive[..., None], nxt.n, hit_n)
        mid = jnp.where(alive, nxt.mat, mid)
        return (L, throughput, alive, hit_p, ray_d, hit_n, mid, rays), None

    carry = (L, throughput, alive, hit_p, ray_d, hit.n, hit.mat, rays)
    if n_bounces > 0:
        carry, _ = jax.lax.scan(bounce, carry, jnp.arange(n_bounces))

    # Final vertex still runs direct lighting (the reference's deepest
    # at_least_one_bounce call does NEE before trace=false).
    L, throughput, alive, hit_p, ray_d, hit_n, mid, rays = carry
    kb = rng.fold(keys, 90000 + n_bounces)
    delta = bsdf_ops.is_delta(scene.materials, mid)
    if cfg.direct_hemisphere_sample:
        direct = _nee_hemisphere(scene, hit_p, hit_n, -ray_d, mid, kb, cfg)
    else:
        direct = _nee(scene, hit_p, hit_n, -ray_d, mid, kb, cfg)
    L += jnp.where((alive & ~delta)[..., None], throughput * direct, 0.0)
    rays += jnp.sum((alive & ~delta).astype(jnp.float32)) * nl_shadow
    if return_stats:
        return L, {"rays": rays}
    return L


def sample_camera_rays(scene: Scene, keys, width, height, pixel_ids,
                       cfg: RenderConfig):
    """Jittered primary rays for flat pixel ids [S] (raytrace_pixel setup:
    bidirection.cpp:513-524 / pathtracer.cpp:298-312).
    keys: per-lane PRNG keys [S]."""
    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)
    u = rng.uniform(rng.fold(keys, 1), (2,))
    x = (px + u[..., 0]) / width
    y = (py + u[..., 1]) / height
    if cfg.integrator == "pt":
        # reference PT uses the thin-lens generator (pathtracer.cpp:311-312)
        ul = rng.uniform(rng.fold(keys, 2), (2,))
        return camera_ops.generate_ray_thin_lens(
            scene.camera, x, y, ul[..., 0], ul[..., 1] * 2.0 * jnp.pi)
    return camera_ops.generate_ray(scene.camera, x, y)
