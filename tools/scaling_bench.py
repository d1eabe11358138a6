"""Scaling-efficiency harness: weak scaling + collective-cost isolation.

This runs on virtual CPU devices (XLA's host platform device count), so it
measures what CAN be measured there honestly and encodes the method for
real cards:

  WEAK scaling (default): work PER DEVICE is held fixed — the frame grows
  with the dp axis (height = base_h * dp) and spp grows with the sp axis —
  so ideal behavior is FLAT wall time as devices are added.  All virtual
  CPU devices share this host's cores, so the flat-ideal only holds while
  devices <= cores ("the core-count budget"); beyond it the run is
  core-starved by construction and the harness reports a core-normalized
  efficiency (ideal wall = t_1 * N/cores) alongside the raw one, plus the
  measured CPU utilization of every run so the two regimes are
  distinguishable in the artifact itself.

  PSUM ablation: the sharded step is also compiled with its collectives
  (the light-image psum — the only cross-device communication in the
  render step, parallel/render.py) replaced by local no-ops; the wall-time
  delta at fixed mesh isolates the collective + replication overhead from
  everything else.  This is the SPMD-overhead number the strong-scaling
  harness of round 2 could not separate from host oversubscription.

  CHIP sanity (--chip): on one accelerator, the dp=1 sharded step vs the
  unsharded step — shard_map plumbing must be free on one device.

Writes build/scaling.json.  Usage:
    python tools/scaling_bench.py [--spp 4] [--size 160 30] [--chip]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import textwrap

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:     # `python tools/scaling_bench.py` puts tools/
    sys.path.insert(0, REPO)  # first; the in-process --chip mode needs REPO

WORKER = textwrap.dedent("""
    import sys, time, json, os, resource
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", int(sys.argv[1]))
    sys.path.insert(0, %(repo)r)
    import numpy as np
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.parallel.render import (
        make_render_mesh, _pass_fn)

    n, w, h, spp, sp, psum_on = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), int(sys.argv[4]),
                                 int(sys.argv[5]), int(sys.argv[6]))
    from bidirectional_pathtracing.scene.build import load_scene
    scene, _ = load_scene(
        "/root/reference/dae/sky/CBspheres_lambertian.dae", w, h)
    cfg = RenderConfig(spp=spp, max_ray_depth=4, width=w, height=h,
                       integrator="bdpt")
    mesh = make_render_mesh(jax.devices(), sp=sp)
    n_dp = mesh.shape["dp"]; n_sp = mesh.shape["sp"]

    @partial(jax.jit, static_argnames=())
    def step(scene, key):
        total = h * w
        pad = (-total) %% n_dp
        pixel_ids = jnp.arange(total + pad, dtype=jnp.int32)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P("dp"), P()),
                 out_specs=(P("dp"), P() if psum_on else P(("dp", "sp"))),
                 check_vma=False)
        def shard_fn(scene, pix_shard, key):
            sp_idx = jax.lax.axis_index("sp")
            def body(carry, i):
                eye_acc, light_acc = carry
                k = jax.random.fold_in(key, i * n_sp + sp_idx)
                eye, light = _pass_fn(scene, k, pix_shard, cfg, w, h)
                return (eye_acc + eye, light_acc + light), None
            init = (jnp.zeros((pix_shard.shape[0], 3)),
                    jnp.zeros((h * w, 3)))
            (eye, light), _ = jax.lax.scan(
                body, init, jnp.arange(spp // n_sp))
            if psum_on:
                eye = jax.lax.psum(eye, "sp") / spp
                light = jax.lax.psum(light, ("dp", "sp"))
            else:  # ablation: collectives removed, everything else equal
                light = light[None] / spp
            return eye, light

        return shard_fn(scene, pixel_ids, key)

    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    key = jax.random.key(0)
    eye, light = step(scene, key)
    np.asarray(eye)  # compile + warmup
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    iters = 3
    for i in range(iters):
        eye, light = step(scene, jax.random.fold_in(key, i))
    np.asarray(eye), np.asarray(light)
    dt = (time.perf_counter() - t0) / iters
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu_s = (ru1.ru_utime - ru0.ru_utime + ru1.ru_stime - ru0.ru_stime)
    print("RESULT " + json.dumps(
        {"devices": n, "mesh": dict(mesh.shape), "w": w, "h": h, "spp": spp,
         "psum": bool(psum_on), "wall_s": dt,
         "samples_per_s": w * h * spp / dt,
         "cpu_util_cores": round(cpu_s / iters / dt, 2)}))
""") % dict(repo=REPO)


def run_worker(n, w, h, spp, sp, psum_on=1, pin_cores=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    cmd = [sys.executable, "-c", WORKER, str(n), str(w), str(h), str(spp),
           str(sp), str(psum_on)]
    if pin_cores:
        # pin the whole process (XLA pool included) to `pin_cores` cores:
        # with one core per device, the host core budget is exact and the
        # weak-scaling ideal (flat wall time) is actually attainable
        if shutil.which("taskset") is None:
            print(f"n={n} SKIPPED: taskset unavailable on this host")
            return None
        cmd = ["taskset", "-c", "0-%d" % (pin_cores - 1)] + cmd
    p = subprocess.run(
        cmd,
        capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT ")]
    if not line:
        print(f"n={n} FAILED:\n{p.stdout[-800:]}\n{p.stderr[-800:]}")
        return None
    r = json.loads(line[0][len("RESULT "):])
    print(r)
    return r


def chip_sanity(w, h, spp):
    """One accelerator, dp=1: sharded step vs unsharded step (same work)."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.parallel.render import (
        make_render_mesh, render_step_sharded)
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils.render import (
        _bdpt_step_chunk, _trace_cfg)

    scene, _ = load_scene(
        "/root/reference/dae/sky/CBspheres_lambertian.dae", w, h)
    cfg = RenderConfig(spp=spp, max_ray_depth=4, width=w, height=h,
                       integrator="bdpt")
    mesh = make_render_mesh(jax.devices()[:1])
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    key = jax.random.key(0)

    def timed(fn):
        np.asarray(fn(0)[0])  # compile + warmup
        t0 = time.perf_counter()
        iters = 5
        for i in range(iters):
            out = fn(i)
        np.asarray(out[0]), np.asarray(out[1])
        return (time.perf_counter() - t0) / iters

    tcfg = _trace_cfg(cfg)
    inv = jnp.float32(1.0 / spp)
    t_plain = timed(lambda i: _bdpt_step_chunk(
        scene, jax.random.fold_in(key, i), jnp.int32(0), tcfg, w, h, spp,
        inv))
    t_shard = timed(lambda i: render_step_sharded(
        scene, jax.random.fold_in(key, i), mesh, cfg, spp))
    r = {"workload": f"CBspheres_lambertian {w}x{h} {spp}spp d4 BDPT on "
                     f"the real chip",
         "unsharded_wall_s": round(t_plain, 4),
         "dp1_sharded_wall_s": round(t_shard, 4),
         "sharding_overhead": round(t_shard / t_plain - 1, 4)}
    print(r)
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--size", type=int, nargs=2, default=[160, 30],
                    help="width and PER-DEVICE height (weak scaling grows "
                         "height with dp)")
    ap.add_argument("--chip", action="store_true",
                    help="also run the real-chip dp=1 sanity point")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "scaling.json"))
    args = ap.parse_args()
    w, base_h = args.size
    cores = os.cpu_count()

    # --- weak scaling: fixed work/device -------------------------------
    weak = []
    for (dp, sp) in ((1, 1), (2, 1), (2, 2), (4, 2)):
        n = dp * sp
        r = run_worker(n, w, base_h * dp, args.spp * sp, sp)
        if r:
            weak.append(r)
    if weak:
        t1 = weak[0]["wall_s"]
        # XLA's intra-op pool makes even the 1-device run consume >1 core
        # (cpu_util_cores records the measured burn), so wall-time ratios
        # conflate SPMD overhead with plain core starvation on this
        # 2-core host.  The clean signal is throughput per consumed
        # core-second: flat-or-rising means the SPMD program adds no
        # overhead as devices are added; falling means sharding costs.
        base_pcs = (weak[0]["samples_per_s"] / weak[0]["cpu_util_cores"])
        for r in weak:
            n = r["devices"]
            r["efficiency_raw"] = round(t1 / r["wall_s"], 3)
            r["ideal_wall_s"] = round(t1 * max(1.0, n / cores), 4)
            r["efficiency_core_normalized"] = round(
                r["ideal_wall_s"] / r["wall_s"], 3)
            r["samples_per_core_s"] = round(
                r["samples_per_s"] / r["cpu_util_cores"], 1)
            r["efficiency_per_core"] = round(
                r["samples_per_core_s"] / base_pcs, 3)

    # --- PINNED weak scaling: exactly one host core per device ----------
    # The unpinned runs conflate SPMD overhead with XLA's intra-op pool
    # oversubscribing the 2-core host (the 1-device run alone burns ~1.6
    # cores).  Pinning each run to one core per device makes the core
    # budget exact, so flat wall time through devices == cores is the
    # honest >=90% weak-scaling test this host can express.
    pinned = []
    for dp in (1, 2):
        if dp > cores:
            break
        r = run_worker(dp, w, base_h * dp, args.spp, 1, pin_cores=dp)
        if r:
            r["pinned_cores"] = dp
            pinned.append(r)
    if pinned:
        t1p = pinned[0]["wall_s"]
        for r in pinned:
            r["efficiency"] = round(t1p / r["wall_s"], 3)

    # --- collective-cost ablation at the full-budget mesh ---------------
    # run-to-run noise on this host is a few percent, the same order as
    # the psum cost itself; take the min wall of 3 runs per variant so the
    # share is an upper bound on the collective cost, not a noise sample
    n_ab = min(2, cores)
    with_runs = [run_worker(n_ab, w, base_h * n_ab, args.spp, 1, psum_on=1)
                 for _ in range(3)]
    no_runs = [run_worker(n_ab, w, base_h * n_ab, args.spp, 1, psum_on=0)
               for _ in range(3)]
    with_runs = [r for r in with_runs if r]
    no_runs = [r for r in no_runs if r]
    ablation = None
    if with_runs and no_runs:
        wp = min(r["wall_s"] for r in with_runs)
        np_ = min(r["wall_s"] for r in no_runs)
        ablation = {
            "devices": n_ab,
            "runs_per_variant": 3,
            "wall_s_with_psum_min": wp,
            "wall_s_without_psum_min": np_,
            "psum_share_of_step": round(1 - np_ / wp, 4),
        }
        print(ablation)

    out = {
        "host_cores": cores,
        "workload": f"CBspheres_lambertian {w}x{base_h}/device "
                    f"{args.spp}spp/sp d4 BDPT, WEAK scaling "
                    f"(fixed work per device; ideal = flat wall time "
                    f"while devices <= cores)",
        "weak_scaling": weak,
        "weak_scaling_pinned_1core_per_device": pinned,
        "collective_ablation": ablation,
    }
    if args.chip:
        try:
            out["chip_dp1_sanity"] = chip_sanity(160, 120, 4)
        except Exception as e:  # chip may be busy/unavailable
            out["chip_dp1_sanity"] = {"error": str(e)}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
