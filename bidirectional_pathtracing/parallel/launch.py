"""Multi-host entry point: jax.distributed + cross-process frame assembly.

The reference is strictly single-process (SURVEY.md section 2.5: a mutex
work queue and worker threads, no MPI/NCCL anywhere).  The equivalent
here: `jax.distributed.initialize` across hosts, one global ('dp','sp')
mesh, scene replicated, light-image psum across devices (NCCL on GPUs) —
which is exactly parallel/render.py's shard_map run under a global mesh.

This module adds the process-level plumbing:

  - initialize(): jax.distributed.initialize with explicit
    coordinator/num_processes/process_id (CPU test rigs use gloo
    collectives; tests/test_multiprocess.py runs 2 processes x 2
    virtual CPU devices and asserts bitwise equality with single-process)
  - render_frame_multihost(): renders over ALL connected processes'
    devices and gathers the frame to every host (eye image dp-sharded
    across processes -> process_allgather; light image already replicated
    by the psum)
  - a __main__ so each host can run
      python -m bidirectional_pathtracing.parallel.launch \
          --coordinator host0:1234 --num-processes N --process-id I ...
    process 0 writes the PNG.

Determinism: per-(pixel,sample) counter RNG makes the multi-host render
bitwise identical to the single-host one for any mesh shape.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None):
    """jax.distributed.initialize, with CPU-backend gloo fallback.

    Pass the coordinator (host:port of process 0), the process count and
    this process's id explicitly; cluster managers that JAX recognises
    may supply them instead.  Safe to call once per process before any
    other JAX API.
    """
    import jax
    # NOTE: must not touch the backend (jax.devices()/default_backend())
    # before distributed.initialize.  gloo only affects the CPU backend,
    # so setting it unconditionally is safe on accelerators.
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older JAX: single-controller CPU only
    kwargs = {}
    if coordinator_address:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    if local_device_ids is not None:
        kwargs.update(local_device_ids=local_device_ids)
    jax.distributed.initialize(**kwargs)


def render_frame_multihost(scene, cfg, sp: int = 1, seed=None):
    """Render cfg over the global mesh of every connected process.

    Returns numpy (eye, light, combined) [H,W,3], identical on all hosts.
    """
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bidirectional_pathtracing.parallel.render import (
        make_render_mesh, render_step_sharded)

    mesh = make_render_mesh(jax.devices(), sp=sp)   # global mesh
    key = jax.random.key(cfg.seed if seed is None else seed)
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    eye, light = render_step_sharded(scene, key, mesh, cfg, cfg.spp)
    jax.block_until_ready((eye, light))
    # eye is dp-sharded across processes; gather the full frame everywhere
    eye_np = np.asarray(
        multihost_utils.process_allgather(eye, tiled=True)).reshape(
            cfg.height, cfg.width, 3)
    # light is replicated by the psum; the local shard is the full image
    light_np = np.asarray(light.addressable_data(0)).reshape(
        cfg.height, cfg.width, 3)
    if cfg.integrator != "bdpt":
        light_np = np.zeros_like(light_np)
    return eye_np, light_np, eye_np + light_np


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="bdpt-launch",
        description="multi-host SPMD renderer (one process per host)")
    ap.add_argument("scene")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("-s", dest="spp", type=int, default=4)
    ap.add_argument("-m", dest="max_depth", type=int, default=5)
    ap.add_argument("-r", dest="size", type=int, nargs=2,
                    default=[480, 360], metavar=("W", "H"))
    ap.add_argument("-f", dest="output", default="out.png")
    ap.add_argument("--integrator", choices=["bdpt", "pt"], default="bdpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp", type=int, default=1,
                    help="sample-parallel mesh axis size")
    ap.add_argument("--stats-json", default="")
    args = ap.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id)

    import jax
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils import image as img

    w, h = args.size
    cfg = RenderConfig(spp=args.spp, max_ray_depth=args.max_depth,
                       width=w, height=h, integrator=args.integrator,
                       seed=args.seed, output=args.output)
    scene, aux = load_scene(args.scene, w, h)
    print(f"[bdpt] process {jax.process_index()}/{jax.process_count()}:"
          f" {len(jax.local_devices())} local / {len(jax.devices())} global"
          f" devices", file=sys.stderr)
    t0 = time.perf_counter()
    eye, light, combined = render_frame_multihost(scene, cfg, sp=args.sp)
    dt = time.perf_counter() - t0
    samples = w * h * args.spp
    if jax.process_index() == 0:
        img.save_image(args.output, combined)
        print(f"[bdpt] {samples} samples in {dt:.2f}s "
              f"({samples/dt:.0f} samples/s) -> {args.output}",
              file=sys.stderr)
        if args.stats_json:
            import json
            with open(args.stats_json, "w") as f:
                json.dump({"wall_time_s": dt, "samples": samples,
                           "samples_per_s": samples / dt,
                           "processes": jax.process_count(),
                           "devices": len(jax.devices())}, f)


if __name__ == "__main__":
    main()
