"""Render driver: sample accumulation, adaptive sampling, stats.

Plays the role of RaytracedRenderer (reference
src/pathtracer/raytraced_renderer.cpp) without the thread pool: the frame
is a flat [W*H] wavefront; one jitted step renders one sample-per-pixel
pass; the host loop accumulates passes on device.  Work distribution across
chips happens in parallel/render.py via shard_map over the same step.

Implements:
  - sample accumulation buffers (eye/light/combined, bidirection.h:81)
  - adaptive sampling with the 95% CI rule for the unidirectional
    integrator (pathtracer.cpp:301-333), batched by cfg.samples_per_batch;
    deliberately disabled for BDPT like the reference (bidirection.cpp:516)
  - end-of-run stats: wall time, rays traced, Mrays/s
    (raytraced_renderer.cpp:677-683)
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.scene.types import Scene


@dataclasses.dataclass
class RenderResult:
    combined: np.ndarray            # [H,W,3] (eye + light for BDPT)
    eye: Optional[np.ndarray]       # [H,W,3] BDPT eye image
    light: Optional[np.ndarray]     # [H,W,3] BDPT light image
    sample_counts: np.ndarray       # [H,W] samples actually taken
    stats: dict


def _lane_rays_per_sample(cfg: RenderConfig, num_lights: int) -> float:
    """STATIC hardware lane launches per camera sample: the wavefront
    intersects every lane at every step regardless of liveness (what the
    chip actually computes).  The MEASURED per-ray count (the reference's
    total_rays, bvh.h:136) is carried out of the jitted step instead."""
    d = max(cfg.max_ray_depth, 1)
    nv = d + 1
    if cfg.integrator == "bdpt":
        # two (nv-1)-step walks + one occlusion launch per i_light>=1 combo
        return 2 * (nv - 1) + nv * nv
    return d * (1 + num_lights * cfg.light_samples)


def _cell_pixel_ids(cfg: RenderConfig, width: int, height: int):
    """Flat pixel ids for the render area; -p cell mode restricts to the
    rect (raytraced_renderer.cpp:302-320 cell semantics)."""
    if cfg.cell:
        x, y, dx, dy = cfg.cell
        xs = jnp.arange(x, min(x + dx, width), dtype=jnp.int32)
        ys = jnp.arange(y, min(y + dy, height), dtype=jnp.int32)
        return (ys[:, None] * width + xs[None, :]).reshape(-1)
    return jnp.arange(width * height, dtype=jnp.int32)


def _trace_cfg(cfg: RenderConfig) -> RenderConfig:
    """Canonicalize the fields that do NOT enter the traced computation
    (spp rides in as the traced inv_ns_aa operand; seed enters via the
    key; the rest is host-side driver/IO policy), so one compiled step
    serves every spp/seed/output combination."""
    return dataclasses.replace(
        cfg, spp=1, seed=0, output="", save_rate_image=False,
        save_eye_light_images=False, samples_per_chunk=0,
        samples_per_batch=32, max_tolerance=0.05, adaptive_sampling=False)


def _auto_chunk(cfg: RenderConfig, checkpoint_every: int = 0) -> int:
    """Camera-sample passes per jitted dispatch.  Larger chunks amortize
    host->device dispatch latency without growing the device wavefront —
    the chunk is a lax.scan, so memory is one pass's.  Bounded by
    checkpoint granularity when checkpointing is on."""
    c = cfg.samples_per_chunk if cfg.samples_per_chunk >= 1 \
        else min(cfg.spp, 8)
    if checkpoint_every > 0:
        c = min(c, checkpoint_every)
    return max(c, 1)


@partial(jax.jit, static_argnames=("cfg", "width", "height"))
def _pt_step(scene: Scene, key, cfg: RenderConfig, width: int, height: int):
    from bidirectional_pathtracing.core import rng
    from bidirectional_pathtracing.models import pathtracer as pt
    pix = _cell_pixel_ids(cfg, width, height)
    keys = rng.lane_keys(key, pix)
    o, d = pt.sample_camera_rays(scene, keys, width, height, pix, cfg)
    L, st = pt.trace_radiance(scene, o, d, keys, cfg, return_stats=True)
    return L, st["rays"]


@partial(jax.jit, static_argnames=("cfg", "width", "height", "chunk"))
def _pt_step_chunk(scene: Scene, key, base, cfg: RenderConfig,
                   width: int, height: int, chunk: int, active):
    """`chunk` PT passes in one dispatch with on-device accumulation.

    Keys are fold_in(key, base + i) — the same stream as dispatching the
    passes one at a time.  `active` masks converged lanes (adaptive
    sampling, pathtracer.cpp:301-333); returns the batch's luminance
    moment sums for the CI rule.
    """
    from bidirectional_pathtracing.core import rng
    from bidirectional_pathtracing.models import pathtracer as pt
    pix = _cell_pixel_ids(cfg, width, height)

    def body(carry, i):
        acc, s1, s2, rays = carry
        k = jax.random.fold_in(key, base + i)
        keys = rng.lane_keys(k, pix)
        o, d = pt.sample_camera_rays(scene, keys, width, height, pix, cfg)
        L, st = pt.trace_radiance(scene, o, d, keys, cfg, return_stats=True)
        lum = jnp.sum(L * jnp.array([0.2126, 0.7152, 0.0722]), -1)
        return (acc + jnp.where(active[:, None], L, 0.0),
                s1 + jnp.where(active, lum, 0.0),
                s2 + jnp.where(active, lum * lum, 0.0),
                rays + st["rays"]), None

    npix = pix.shape[0]
    init = (jnp.zeros((npix, 3)), jnp.zeros((npix,)), jnp.zeros((npix,)),
            jnp.float32(0))
    (acc, s1, s2, rays), _ = jax.lax.scan(body, init, jnp.arange(chunk))
    return acc, s1, s2, rays


@partial(jax.jit, static_argnames=("cfg", "width", "height"))
def _bdpt_step(scene: Scene, key, cfg: RenderConfig, width: int, height: int):
    from bidirectional_pathtracing.models import bdpt
    pix = _cell_pixel_ids(cfg, width, height)
    eye, light, st = bdpt.sample_pass(scene, key, width, height, pix, cfg,
                                      return_stats=True)
    return eye, light, st["rays"]


@partial(jax.jit, static_argnames=("cfg", "width", "height", "chunk"))
def _bdpt_step_chunk(scene: Scene, key, base, cfg: RenderConfig,
                     width: int, height: int, chunk: int, inv_ns_aa=None):
    """`chunk` sample passes in one jitted step (cfg.samples_per_chunk).

    Scans over pass indices base..base+chunk-1 with the same
    fold_in(key, i) keys as the one-pass step, so the sample stream is
    bitwise identical to chunk=1 — only dispatch count changes.
    """
    from bidirectional_pathtracing.models import bdpt
    pix = _cell_pixel_ids(cfg, width, height)

    def body(carry, i):
        eye_acc, light_acc, rays_acc = carry
        k = jax.random.fold_in(key, base + i)
        eye_i, light_i, st = bdpt.sample_pass(scene, k, width, height, pix,
                                              cfg, return_stats=True,
                                              inv_ns_aa=inv_ns_aa)
        return (eye_acc + eye_i, light_acc + light_i,
                rays_acc + st["rays"]), None

    npix = pix.shape[0]
    init = (jnp.zeros((npix, 3)), jnp.zeros((width * height, 3)),
            jnp.float32(0))
    (eye, light, rays), _ = jax.lax.scan(body, init, jnp.arange(chunk))
    return eye, light, rays


def render(scene: Scene, cfg: RenderConfig, seed: Optional[int] = None,
           checkpoint_path: Optional[str] = None,
           checkpoint_every: int = 0,
           cancel: Optional[object] = None) -> RenderResult:
    """Render a full frame.  Returns HDR buffers with rows bottom-up
    (pixel (0,0) = bottom-left, matching the reference sample buffer).

    With checkpoint_path set, accumulation state is persisted every
    checkpoint_every passes and restored on restart (identical sample
    stream thanks to the counter-based RNG; utils/checkpoint.py).

    cancel: optional object with a truthy `is_set()` (e.g.
    threading.Event) — the cooperative-stop equivalent of the reference's
    continueRaytracing flag (raytraced_renderer.cpp:226,611): checked
    between dispatched chunks (cfg.samples_per_chunk passes; the
    reference's granularity is a tile row); on cancel the accumulated
    samples so far are returned (normalized by passes actually taken)
    and, when checkpointing, saved.
    """
    from bidirectional_pathtracing.ops import lights as light_ops
    from bidirectional_pathtracing.utils import checkpoint as ckpt

    w, h = cfg.width, cfg.height
    the_seed = cfg.seed if seed is None else seed
    key = jax.random.key(the_seed)
    t0 = time.perf_counter()
    fp = ckpt.config_fingerprint(cfg, w, h) if checkpoint_path else None

    pix_dev = _cell_pixel_ids(cfg, w, h)     # device-resident (uploading a
    pix_np = np.asarray(pix_dev)             # fresh index array per chunk
    full_frame = cfg.cell is None            # dominated round-2 wall time)
    tcfg = _trace_cfg(cfg)
    if cfg.integrator == "bdpt":
        inv = jnp.float32(1.0 / cfg.spp)
        eye = jnp.zeros((h * w, 3))
        light = jnp.zeros((h * w, 3))
        start = 0
        if checkpoint_path:
            st = ckpt.load_checkpoint(checkpoint_path, fp)
            if st is not None and st["seed"] == the_seed:
                eye = jnp.asarray(st["eye_sum"])
                light = jnp.asarray(st["light_sum"])
                start = st["next_pass"]
        rays_total = jnp.float32(0)
        chunk = _auto_chunk(cfg, checkpoint_every)
        i = start
        while i < cfg.spp:
            n = min(chunk, cfg.spp - i)
            eye_i, light_i, rays_i = _bdpt_step_chunk(
                scene, key, jnp.int32(i), tcfg, w, h, n, inv)
            rays_total = rays_total + rays_i
            if full_frame:
                eye = eye + eye_i * inv
            else:
                eye = eye.at[pix_dev].add(eye_i * inv)
            light = light + light_i  # splats already carry 1/ns_aa
            i += n
            if (checkpoint_path and checkpoint_every
                    and i % checkpoint_every == 0 and i < cfg.spp):
                ckpt.save_checkpoint(
                    checkpoint_path, eye_sum=np.asarray(eye),
                    light_sum=np.asarray(light),
                    counts=np.full((h * w,), i, np.int32),
                    next_pass=i, seed=the_seed, fingerprint=fp)
            if cancel is not None and cancel.is_set() and i < cfg.spp:
                # cooperative stop (continueRaytracing): keep the i passes
                # taken so far, renormalized below; resumable when
                # checkpointing is on
                if checkpoint_path:
                    ckpt.save_checkpoint(
                        checkpoint_path, eye_sum=np.asarray(eye),
                        light_sum=np.asarray(light),
                        counts=np.full((h * w,), i, np.int32),
                        next_pass=i, seed=the_seed, fingerprint=fp)
                break
        passes = i
        # buffers accumulate /cfg.spp per pass; renormalize for early stop
        scale = cfg.spp / max(passes, 1)
        eye = np.asarray(jax.block_until_ready(eye)).reshape(h, w, 3) * scale
        light = np.asarray(light).reshape(h, w, 3) * scale
        combined = eye + light
        counts = np.full((h, w), passes, np.int32)
    else:
        eye = light = None
        rays_total = jnp.float32(0)
        npix = pix_np.shape[0]
        acc = jnp.zeros((npix, 3))
        s1 = jnp.zeros((npix,))
        s2 = jnp.zeros((npix,))
        counts_dev = jnp.zeros((npix,), jnp.int32)
        active = jnp.ones((npix,), bool)
        batch = cfg.samples_per_batch if cfg.adaptive_sampling else cfg.spp
        chunk = _auto_chunk(cfg, checkpoint_every)
        done = 0
        while done < cfg.spp:
            n = min(batch, cfg.spp - done)
            for j in range(0, n, chunk):
                c = min(chunk, n - j)
                acc_i, s1_i, s2_i, rays_i = _pt_step_chunk(
                    scene, key, jnp.int32(done + j), tcfg, w, h, c, active)
                rays_total = rays_total + rays_i
                acc, s1, s2 = acc + acc_i, s1 + s1_i, s2 + s2_i
                counts_dev = counts_dev + c * active.astype(jnp.int32)
            done += n
            if cancel is not None and cancel.is_set():
                break
            if cfg.adaptive_sampling and done < cfg.spp:
                nn = counts_dev.astype(jnp.float32)
                mu = s1 / jnp.maximum(nn, 1)
                var = jnp.maximum(s2 - s1 * s1 / jnp.maximum(nn, 1), 0.0) \
                    / jnp.maximum(nn - 1, 1)
                ci = 1.96 * jnp.sqrt(var / jnp.maximum(nn, 1))
                converged = (ci <= cfg.max_tolerance * mu) & (mu > 1e-5)
                active = active & ~converged
                if not bool(jnp.any(active)):
                    break
        counts_cell = np.asarray(jax.block_until_ready(counts_dev))
        counts_np = np.zeros((h * w,), np.int32)
        counts_np[pix_np] = counts_cell
        full = np.zeros((h * w, 3))
        full[pix_np] = (np.asarray(acc)
                        / np.maximum(counts_cell, 1)[:, None])
        combined = full.reshape(h, w, 3)
        counts = counts_np.reshape(h, w)

    dt = time.perf_counter() - t0
    n_samples = int(counts.sum())
    rays = float(rays_total)   # measured (carried out of the jitted steps)
    lane_rays = n_samples * _lane_rays_per_sample(
        cfg, light_ops.num_lights(scene.lights))
    stats = {
        "wall_time_s": dt,
        "camera_samples": n_samples,
        "camera_samples_per_s": n_samples / dt,
        "rays": rays,
        "mrays_per_s": rays / dt / 1e6,
        "lane_rays": lane_rays,
        "lane_mrays_per_s": lane_rays / dt / 1e6,
        "rays_per_sample": rays / max(n_samples, 1),
    }
    return RenderResult(combined=combined, eye=eye, light=light,
                        sample_counts=counts, stats=stats)


def autofocus(scene: Scene, x: float, y: float,
              width: int, height: int) -> float:
    """PathTracer::autofocus (pathtracer.cpp:342-349): cast the camera ray
    through pixel location (x, y), return the hit distance as the new focal
    distance (inf on a miss, like the reference's uninitialised isect.t).

    Use: scene = scene._replace(camera=scene.camera._replace(
        focal_distance=jnp.float32(autofocus(scene, x, y, w, h))))
    """
    from bidirectional_pathtracing.ops import camera_ops
    from bidirectional_pathtracing.ops.intersect import scene_intersect

    o, d = camera_ops.generate_ray(
        scene.camera,
        jnp.asarray([x / width], jnp.float32),
        jnp.asarray([y / height], jnp.float32))
    hit = scene_intersect(scene, o, d,
                          jnp.broadcast_to(scene.camera.nclip, (1,)),
                          jnp.broadcast_to(scene.camera.fclip, (1,)))
    return float(hit.t[0])
