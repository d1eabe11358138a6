"""Multi-chip SPMD rendering via jax.sharding + shard_map.

Replaces the reference's only parallelism — a mutex work queue feeding
worker threads over 32x32 tiles (reference src/pathtracer/
raytraced_renderer.cpp:267-328, src/util/work_queue.h) — with static SPMD
over a device mesh (SURVEY.md section 2.5 mapping):

  - mesh axes ('dp', 'sp'): pixels sharded over dp, camera-sample chunks
    over sp; the scene/BVH pytree is replicated.
  - eye-image contributions are disjoint per pixel shard; light-image
    splats (the reference's mutex-guarded buffer, bidirection.cpp:544-551)
    become per-device scatter-adds reduced with lax.psum — no locks.
  - counter-based keys are derived from (pixel, sample) ids, so the render
    is bitwise identical for any mesh shape (tested in test_parallel.py).

Multi-host: the same code runs under jax.distributed.initialize with a
global mesh.  The mesh follows the algorithm only: the cards of one host
are all-to-all (NVLink on the H100), so no device order is preferred.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.scene.types import Scene


def make_render_mesh(devices=None, sp: int = 1) -> Mesh:
    """1D or 2D mesh over the given devices: ('dp', 'sp')."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % sp != 0:
        raise ValueError(f"{n} devices not divisible by sp={sp}")
    arr = np.array(devices).reshape(n // sp, sp)
    return Mesh(arr, ("dp", "sp"))


def _pass_fn(scene, key, pixel_ids, cfg: RenderConfig, width, height):
    if cfg.integrator == "bdpt":
        from bidirectional_pathtracing.models import bdpt
        return bdpt.sample_pass(scene, key, width, height, pixel_ids, cfg)
    from bidirectional_pathtracing.core import rng
    from bidirectional_pathtracing.models import pathtracer as pt
    keys = rng.lane_keys(key, pixel_ids)
    o, d = pt.sample_camera_rays(scene, keys, width, height, pixel_ids, cfg)
    L = pt.trace_radiance(scene, o, d, keys, cfg)
    return L, jnp.zeros((height * width, 3))


@partial(jax.jit, static_argnames=("cfg", "mesh", "spp_chunk"))
def render_step_sharded(scene: Scene, base_key, mesh: Mesh,
                        cfg: RenderConfig, spp_chunk: int):
    """Render spp_chunk samples/pixel over the mesh.

    Returns (eye [H*W,3] sharded over dp, light [H*W,3] replicated).
    Accumulations carry 1/spp normalisation for the light image (reference
    splat semantics) and raw sums for the eye image.
    """
    w, h = cfg.width, cfg.height
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    total = h * w
    pad = (-total) % n_dp
    pixel_ids = jnp.arange(total + pad, dtype=jnp.int32)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P("dp"), P()),
        out_specs=(P("dp"), P()),
        check_vma=False,
    )
    def shard_fn(scene, pix_shard, key):
        sp_idx = jax.lax.axis_index("sp")

        def body(carry, i):
            eye_acc, light_acc = carry
            k = jax.random.fold_in(key, i * n_sp + sp_idx)
            eye, light = _pass_fn(scene, k, pix_shard, cfg, w, h)
            return (eye_acc + eye, light_acc + light), None

        n_local = spp_chunk // n_sp
        init = (jnp.zeros((pix_shard.shape[0], 3)),
                jnp.zeros((h * w, 3)))
        (eye, light), _ = jax.lax.scan(body, init, jnp.arange(n_local))
        # eye contributions from different sp rows are independent samples
        eye = jax.lax.psum(eye, "sp") / spp_chunk
        light = jax.lax.psum(light, ("dp", "sp"))
        return eye, light

    eye, light = shard_fn(scene, pixel_ids, base_key)
    return eye[:total], light


def render_frame_sharded(scene: Scene, cfg: RenderConfig, mesh=None,
                         seed=None):
    """Full frame over a mesh; returns (eye, light, combined) numpy [H,W,3]."""
    if mesh is None:
        mesh = make_render_mesh()
    if cfg.spp % (mesh.shape["sp"]) != 0:
        raise ValueError("spp must be divisible by the sp mesh axis")
    key = jax.random.key(cfg.seed if seed is None else seed)
    # replicate the scene across the mesh
    scene = jax.device_put(
        scene, NamedSharding(mesh, P()))
    eye, light = render_step_sharded(scene, key, mesh, cfg, cfg.spp)
    eye = np.asarray(jax.block_until_ready(eye)).reshape(
        cfg.height, cfg.width, 3)
    light = np.asarray(light).reshape(cfg.height, cfg.width, 3)
    if cfg.integrator != "bdpt":
        light = np.zeros_like(light)
    return eye, light, eye + light
