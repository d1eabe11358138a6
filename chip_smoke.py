#!/usr/bin/env python3
"""Smoke test of the BDPT render path on an NVIDIA GPU.

    python3 chip_smoke.py             # one card: phases a-f below
    python3 chip_smoke.py --cards 4   # four cards: sharded frame vs one card

Phases, in the order they run; the script exits non-zero at the first that
fails and prints the JSON result line only when every phase passed:

  a. device      jax.devices()[0].platform must be "gpu"; never the CPU.
  c. precision   generate_ray and make_coord_space/to_world on the card vs
                 float64 numpy (the transforms must not run in TF32).
  b. kernels     the brute-force Triton kernel (ops/intersect_triton.py) vs
                 the plain jnp `intersect`/`occluded` on the 172,800 camera
                 rays of a 480x360 frame, their first bounce and a
                 6.2M-segment shadow batch (36 combos x 172,800 lanes, the
                 BDPT d5 shadow launch), on the 14-prim mirror/glass box and
                 the level-2 icosphere box; `intersect_bvh` vs the plain path
                 on the level-5 icosphere box (20,492 tris).
  d. renders     through utils.render.render(): BDPT 480x360 d5 8 spp on the
                 mirror/glass box and on the level-5 box, MIS-PT on the
                 mirror/glass box; compile s, wall s, samples/s, Mrays/s and
                 peak device bytes each.  Then the referee: BDPT vs MIS-PT
                 (pt_reference_nee=False) block errors on the mirror/glass
                 and the lambertian box.
  e. gradient    jax.grad of a BDPT image loss w.r.t. albedo on a small box
                 (kernel path): finite and non-zero.
  f. timing      the 480x360 d5 BDPT step (8 passes, as render() dispatches
                 it) with the kernel and with the plain jnp path, in turns,
                 on the mirror/glass box and the level-2 box.

Tolerances (each with its reason):
  - closest hit: lanes whose t lies within 1e-5 * |min_t| of min_t or
    1e-5 * max(1, |max_t|) of max_t are a tie band (f32 rounding decides
    them either way) and are not compared.  Elsewhere valid must agree,
    t must agree to a relative 1e-5 on triangles and 1e-4 on spheres
    (measured against max(1, t); the kernel divides with Triton's
    approximate f32 division and both sides contract to FMA differently;
    the sphere quadratic cancels), and prim may differ only where t
    agrees (a shared edge).  Lanes breaking these rules may number at most
    1e-5 of the batch: Moller-Trumbore is not watertight in f32, so a ray
    through a shared edge can slip between both triangles on one side.
  - any hit: the plain path is evaluated on the window shrunk and grown by
    the tie band; lanes where those differ are not compared, and the kernel
    must match the plain result elsewhere on all but 1e-5 of the lanes.
  - precision: max abs error 4e-6 against float64 (a few f32 ulps; TF32
    would show errors near 1e-3).
  - referee: 6x6 block means, err = |bdpt - pt| / (|pt| + 0.05), mean
    below 0.05 and max below 0.25 (the repo's own referee,
    tests/test_microfacet.py), at 8 spp and 480x360: 38,400 samples per
    block, four times the test's count.  Most of the error left at that
    count is the bias of the reference-parity camera pricing
    (RenderConfig.bdpt_consistent_camera), as in the repo's test.
  - --cards 4: the sharded frame vs the same frame on one card, per pixel
    |a - b| <= 1e-4 * (|b| + mean(b)): the light image is a scatter-add
    (atomics in no fixed order on a GPU) reduced by psum, so sums differ
    in their last bits.
All geometry runs in f32 with elementwise arithmetic (no TF32 anywhere).

Prints the card's name and power limit first (nvidia-smi), and as the last
line of stdout {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

W, H, DEPTH, SPP = 480, 360, 5, 8
SHADOW_COMBOS = 36        # (s,t) combos with a shadow ray at depth 5
BAND = 1e-5               # tie band: BAND*|min_t| and BAND*max(1, |max_t|)
TOL_T_TRI, TOL_T_SPH = 1e-5, 1e-4
MAX_BAD_FRAC = 1e-5
PRECISION_TOL = 4e-6


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    log(("  ok   " if ok else "  FAIL ") + msg)
    if not ok:
        raise PhaseError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def peak_bytes():
    import jax
    return max(d.memory_stats().get("peak_bytes_in_use", 0)
               for d in jax.local_devices())


# --- scenes and ray batches -------------------------------------------------

def scenes():
    from bidirectional_pathtracing.scene.build import attach_accelerator
    from bidirectional_pathtracing.scene.procedural import (
        make_cornell_box, make_icosphere_box)
    return {
        "box14": make_cornell_box(sphere_materials=("mirror", "glass")),
        "ico2": attach_accelerator(make_icosphere_box(2)),
        "ico5": attach_accelerator(make_icosphere_box(5)),
    }


def ray_batches(scene, seed=0):
    """Camera rays of a W x H frame, their first bounce and a shadow batch
    of SHADOW_COMBOS x W*H segments; each as (o, d, min_t, max_t)."""
    import jax
    import jax.numpy as jnp
    from bidirectional_pathtracing.core.math import EPS_F
    from bidirectional_pathtracing.ops import camera_ops
    from bidirectional_pathtracing.ops.intersect import intersect

    @jax.jit
    def make(scene, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        pix = jnp.arange(W * H)
        u = jax.random.uniform(k1, (W * H, 2))
        x = ((pix % W) + u[:, 0]) / W
        y = ((pix // W) + u[:, 1]) / H
        o, d = camera_ops.generate_ray(scene.camera, x, y)
        n = o.shape[0]
        cam = (o, d, jnp.broadcast_to(scene.camera.nclip, (n,)),
               jnp.broadcast_to(scene.camera.fclip, (n,)))
        hit = intersect(scene.geometry, *cam)
        p = o + jnp.where(hit.valid, hit.t, 0.0)[:, None] * d
        # first bounce: a uniform direction in the normal's hemisphere
        w = jax.random.normal(k2, (n, 3))
        w = w / jnp.linalg.norm(w, axis=-1, keepdims=True)
        w = jnp.where(jnp.sum(w * hit.n, -1, keepdims=True) < 0, -w, w)
        bounce = (p, w, jnp.full((n,), EPS_F),
                  jnp.where(hit.valid, 1e30, -1.0))
        # shadow batch: each lane's hit point to another lane's hit point
        # or to a point on the light, as the BDPT connections do
        m = SHADOW_COMBOS * n
        a = jnp.tile(p, (SHADOW_COMBOS, 1))
        va = jnp.tile(hit.valid, SHADOW_COMBOS)
        other = jax.random.randint(k3, (m,), 0, n)
        ul = jax.random.uniform(k4, (m, 2)) - 0.5
        li = scene.lights
        on_light = (li.position[0] + ul[:, :1] * li.dim_x[0]
                    + ul[:, 1:] * li.dim_y[0])
        to_light = (jnp.arange(m) // n) % 3 == 0
        b = jnp.where(to_light[:, None], on_light, p[other])
        active = va & (to_light | hit.valid[other])
        dv = b - a
        dist = jnp.sqrt(jnp.maximum(jnp.sum(dv * dv, -1), 1e-20))
        shadow = (a, dv / dist[:, None], jnp.full((m,), EPS_F),
                  jnp.where(active, dist * (1.0 - 2e-4) - EPS_F, -1.0))
        return cam, bounce, shadow

    return make(scene, jax.random.key(seed))


# --- comparisons ------------------------------------------------------------

def _band_widths(lo, hi):
    """Half-widths of the tie band at each window end: relative at min_t
    (surfaces at a ray's own origin sit at |t| ~ 1e-7, below min_t) and
    relative to the scene's unit scale at max_t."""
    import jax.numpy as jnp
    return BAND * jnp.abs(lo), BAND * jnp.maximum(1.0, jnp.abs(hi))


def _band(t, lo, hi):
    import jax.numpy as jnp
    dlo, dhi = _band_widths(lo, hi)
    near = (jnp.abs(t - hi) <= dhi) | (jnp.abs(t - lo) <= dlo)
    return (t < 1e29) & near


def compare_closest(name, num_tris, got, ref, rays):
    """Hit records `got` vs reference `ref` under the closest-hit rules."""
    import jax.numpy as jnp
    _, _, lo, hi = rays
    band = _band(ref.t, lo, hi) | _band(got.t, lo, hi)
    both = got.valid & ref.valid
    rel = jnp.abs(got.t - ref.t) / jnp.maximum(1.0, jnp.abs(ref.t))
    tol = jnp.where(ref.prim >= num_tris, TOL_T_SPH, TOL_T_TRI)
    t_ok = rel <= tol
    bad = ~band & ((got.valid != ref.valid) | (both & ~t_ok))
    n = rays[0].shape[0]
    n_bad = int(jnp.sum(bad))
    n_band = int(jnp.sum(band))
    n_prim = int(jnp.sum(~band & both & (got.prim != ref.prim)))
    max_rel = float(jnp.max(jnp.where(both & ~band, rel, 0.0)))
    check(n_bad <= MAX_BAD_FRAC * n,
          f"{name}: {n} rays, hit frac {float(jnp.mean(ref.valid)):.3f}, "
          f"band {n_band}, bad {n_bad}, prim-only diffs {n_prim}, "
          f"max rel dt {max_rel:.2e}")


def compare_any(name, got, ref_in, ref_out, rays):
    import jax.numpy as jnp
    decided = ref_in == ref_out
    n = rays[0].shape[0]
    n_bad = int(jnp.sum(decided & (got != ref_in)))
    check(n_bad <= MAX_BAD_FRAC * n,
          f"{name}: {n} segments, blocked frac "
          f"{float(jnp.mean(ref_in)):.3f}, band {int(jnp.sum(~decided))}, "
          f"bad {n_bad}")


def _windows(rays):
    """The ray batch with its window shrunk and grown by the tie band."""
    import jax.numpy as jnp
    o, d, lo, hi = rays
    dlo, dhi = _band_widths(lo, hi)
    return (o, d, lo + dlo, hi - dhi), (o, d, lo - dlo, hi + dhi)


def phase_kernels(sc):
    import jax
    from bidirectional_pathtracing.ops import intersect_triton as K
    from bidirectional_pathtracing.ops.intersect import (
        intersect, intersect_bvh, occluded, resolve_hit)

    plain_hit = jax.jit(intersect)
    plain_occ = jax.jit(occluded)

    @jax.jit
    def kernel_hit(g, o, d, lo, hi):
        t, prim = K.closest_hit(g, o, d, lo, hi)
        return resolve_hit(g, o, d, t, prim)

    kernel_occ = jax.jit(K.any_hit)
    for name in ("box14", "ico2"):
        g = sc[name].geometry
        cam, bounce, shadow = ray_batches(sc[name])
        for label, rays in (("camera", cam), ("bounce", bounce)):
            got = kernel_hit(g, *rays)
            compare_closest(f"{name} closest {label}", g.num_tris, got,
                            plain_hit(g, *rays), rays)
        for label, rays in (("camera", cam), ("bounce", bounce),
                            ("shadow", shadow)):
            inner, outer = _windows(rays)
            compare_any(f"{name} any-hit {label}", kernel_occ(g, *rays),
                        plain_occ(g, *inner), plain_occ(g, *outer), rays)
        del cam, bounce, shadow

    s5 = sc["ico5"]
    g = s5.geometry
    cam, bounce, shadow = ray_batches(s5)
    bvh_hit = jax.jit(lambda g, b, *r: intersect_bvh(g, b, *r))
    bvh_occ = jax.jit(lambda g, b, *r: intersect_bvh(g, b, *r, any_hit=True))
    # the BVH's any-hit on a camera-lane-sized slice of the shadow batch
    shadow = tuple(x[:W * H] for x in shadow)
    for label, rays in (("camera", cam), ("bounce", bounce)):
        compare_closest(f"ico5 bvh closest {label}", g.num_tris,
                        bvh_hit(g, s5.bvh, *rays), plain_hit(g, *rays), rays)
    for label, rays in (("bounce", bounce), ("shadow", shadow)):
        inner, outer = _windows(rays)
        compare_any(f"ico5 bvh any-hit {label}", bvh_occ(g, s5.bvh, *rays),
                    plain_occ(g, *inner), plain_occ(g, *outer), rays)


# --- precision ----------------------------------------------------------------

def phase_precision():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bidirectional_pathtracing.core.math import make_coord_space, to_world
    from bidirectional_pathtracing.ops import camera_ops
    from bidirectional_pathtracing.scene.procedural import make_cornell_box

    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    cam = make_cornell_box().camera._replace(
        c2w=jnp.asarray(q, jnp.float32))
    x, y = (rng.uniform(size=4096).astype(np.float32) for _ in range(2))
    _, d = jax.jit(camera_ops.generate_ray)(cam, x, y)
    th = np.tan(np.radians(np.float64(cam.hfov)) / 2)
    tv = np.tan(np.radians(np.float64(cam.vfov)) / 2)
    dc = np.stack([(2 * x.astype(np.float64) - 1) * th,
                   (2 * y.astype(np.float64) - 1) * tv,
                   -np.ones(x.shape)], -1)
    dw = dc @ np.asarray(cam.c2w, np.float64).T
    dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
    err = float(np.abs(np.asarray(d, np.float64) - dw).max())
    check(err <= PRECISION_TOL, f"generate_ray vs float64: max err {err:.2e}")

    n = rng.normal(size=(4096, 3)).astype(np.float32)
    v = rng.normal(size=(4096, 3)).astype(np.float32)
    frame, w = jax.jit(lambda n, v: (lambda f: (f, to_world(f, v)))(
        make_coord_space(n)))(n, v)
    ref = np.einsum("kij,kj->ki", np.asarray(frame, np.float64),
                    v.astype(np.float64))
    err = float(np.abs(np.asarray(w, np.float64) - ref).max())
    check(err <= PRECISION_TOL,
          f"make_coord_space/to_world vs float64: max err {err:.2e}")


# --- renders ------------------------------------------------------------------

def _blocks(img, nb=6):
    h, w = img.shape[:2]
    bh, bw = h // nb, w // nb
    return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))


def timed_render(name, scene, cfg, card):
    """render() twice: the first compiles, the second is the timed one."""
    import numpy as np
    from bidirectional_pathtracing.utils.render import render
    first = render(scene, cfg)
    res = render(scene, cfg)
    st = res.stats
    compile_s = first.stats["wall_time_s"] - st["wall_time_s"]
    img = res.combined
    log(f"  {name}: {cfg.integrator} {cfg.width}x{cfg.height} "
        f"d{cfg.max_ray_depth} {cfg.spp} spp | compile {compile_s:.1f} s "
        f"(set-up) | wall {st['wall_time_s']:.3f} s | "
        f"{st['camera_samples_per_s']:.0f} samples/s | "
        f"{st['mrays_per_s']:.2f} Mrays/s | peak {peak_bytes()} B | "
        f"{card}")
    check(bool(np.isfinite(img).all()), f"{name}: image finite")
    check(float(img.mean()) > 1e-3, f"{name}: image lit "
          f"(mean {float(img.mean()):.4f})")
    return res


def phase_renders(sc, card):
    import numpy as np
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.procedural import make_cornell_box
    from bidirectional_pathtracing.utils.render import render

    bdpt = RenderConfig(spp=SPP, max_ray_depth=DEPTH, width=W, height=H,
                        integrator="bdpt")
    pt = RenderConfig(spp=SPP, max_ray_depth=DEPTH, width=W, height=H,
                      integrator="pt", light_samples=2,
                      pt_reference_nee=False, pt_mis=True)
    b14 = timed_render("box14 bdpt", sc["box14"], bdpt, card)
    p14 = timed_render("box14 mis-pt", sc["box14"], pt, card)
    timed_render("ico5 bdpt (bvh)", sc["ico5"], bdpt, card)

    # Referee, as tests/test_microfacet.py does it.  The lambertian box has
    # the mirror/glass box's shapes and reuses its compiled steps.
    lam = make_cornell_box()
    for name, b, p in (
            ("box14", b14.combined, p14.combined),
            ("lambertian", render(lam, bdpt).combined,
             render(lam, pt).combined)):
        c = _blocks(p)
        err = np.abs(_blocks(b) - c) / (np.abs(c) + 0.05)
        check(err.mean() < 0.05 and err.max() < 0.25,
              f"referee {name}: BDPT vs MIS-PT block err mean "
              f"{err.mean():.4f} (< 0.05), max {err.max():.4f} (< 0.25)")


def phase_gradient():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.models import bdpt
    from bidirectional_pathtracing.ops.intersect import intersector
    from bidirectional_pathtracing.scene.procedural import make_cornell_box

    box = make_cornell_box()
    w, h = 24, 16
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=w, height=h)
    pix = jnp.arange(w * h, dtype=jnp.int32)

    def loss(albedo):
        s = box._replace(materials=box.materials._replace(albedo=albedo))
        eye, light = bdpt.sample_pass(s, jax.random.key(0), w, h, pix, cfg)
        return jnp.mean(eye) + jnp.mean(light)

    g = np.asarray(jax.jit(jax.grad(loss))(box.materials.albedo))
    check(np.isfinite(g).all() and np.abs(g).max() > 0,
          f"grad wrt albedo through the {intersector(box)} path: finite, "
          f"max |g| {np.abs(g).max():.3e}")


def phase_timing(sc, card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.ops import intersect as isect
    from bidirectional_pathtracing.utils.render import (
        _bdpt_step_chunk, _trace_cfg)

    tcfg = _trace_cfg(RenderConfig(spp=SPP, max_ray_depth=DEPTH, width=W,
                                   height=H, integrator="bdpt"))
    key, inv = jax.random.key(0), jnp.float32(1.0 / SPP)

    def kernel_step(scene):
        # the very step render() dispatches (already compiled for box14)
        return lambda base: _bdpt_step_chunk(scene, key, jnp.int32(base),
                                             tcfg, W, H, SPP, inv)

    def plain_step(scene):
        # a fresh jit of the same step, traced with the private switch on
        raw = jax.jit(lambda scene, base: _bdpt_step_chunk.__wrapped__(
            scene, key, base, tcfg, W, H, SPP, inv))
        isect._PLAIN_ONLY = True
        try:
            lowered = raw.lower(scene, jnp.int32(0))
        finally:
            isect._PLAIN_ONLY = False
        check("triton" not in lowered.as_text().lower(),
              "plain step holds no Triton kernel")
        c = lowered.compile()
        return lambda base: c(scene, jnp.int32(base))

    for name in ("box14", "ico2"):
        scene = sc[name]
        steps = {}
        for variant, make in (("kernel", kernel_step), ("plain", plain_step)):
            t0 = time.perf_counter()
            steps[variant] = make(scene)
            jax.block_until_ready(steps[variant](0))
            log(f"  {name} {variant}: compile + first step "
                f"{time.perf_counter() - t0:.1f} s")
        times = {"kernel": [], "plain": []}
        for rnd in range(3):
            for variant in ("kernel", "plain", "plain", "kernel"):
                t0 = time.perf_counter()
                jax.block_until_ready(steps[variant](8 * rnd))
                times[variant].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in times.items()}
        log(f"  {name} step ({W}x{H} d{DEPTH}, {SPP} passes): kernel "
            f"{med['kernel'] * 1e3:.1f} ms, plain XLA "
            f"{med['plain'] * 1e3:.1f} ms, speedup "
            f"{med['plain'] / med['kernel']:.2f}x | all kernel "
            f"{[round(t * 1e3, 1) for t in times['kernel']]} plain "
            f"{[round(t * 1e3, 1) for t in times['plain']]} | {card}")


# --- four cards ---------------------------------------------------------------

def phase_sharded(n_cards, card):
    import jax
    import numpy as np
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.parallel.render import (
        make_render_mesh, render_frame_sharded)
    from bidirectional_pathtracing.scene.procedural import make_cornell_box

    devs = jax.devices()
    check(len(devs) >= n_cards, f"{len(devs)} devices for --cards {n_cards}")
    scene = make_cornell_box(sphere_materials=("mirror", "glass"))
    cfg = RenderConfig(spp=SPP, max_ray_depth=DEPTH, width=W, height=H,
                       integrator="bdpt")
    one = make_render_mesh(devs[:1])
    mesh = make_render_mesh(devs[:n_cards], sp=2)
    out = {}
    for label, m in (("1 card", one), (f"{n_cards} cards", mesh)):
        render_frame_sharded(scene, cfg, m)            # compile
        t0 = time.perf_counter()
        out[label] = render_frame_sharded(scene, cfg, m)
        log(f"  {label} mesh {dict(m.shape)}: wall "
            f"{time.perf_counter() - t0:.3f} s | {card}")
    a, b = out[f"{n_cards} cards"][2], out["1 card"][2]
    check(bool(np.isfinite(a).all()) and float(a.mean()) > 1e-3,
          "sharded image finite and lit")
    diff = np.abs(a - b)
    lim = 1e-4 * (np.abs(b) + b.mean())
    check(bool((diff <= lim).all()),
          f"sharded vs one card: max |diff| {diff.max():.3e}, max "
          f"|diff|/(|b|+mean b) {float((diff / (np.abs(b) + b.mean())).max()):.3e}"
          f" (<= 1e-4)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the sharded frame vs one card")
    ap.add_argument("--phases", default="acbdef",
                    help="subset of the one-card phases to run")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    log(f"[a] device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    if dev.platform != "gpu":
        log("no GPU found: chip_smoke runs on the card only")
        return 1
    card = card_line()
    log(f"card: {card}")

    from bidirectional_pathtracing.utils.compile_cache import (
        enable_compile_cache)
    log(f"compile cache: {enable_compile_cache()}")

    t_start = time.perf_counter()
    try:
        if args.cards > 1:
            log(f"[sharded] {args.cards} cards, ('dp','sp') = "
                f"({args.cards // 2},2)")
            phase_sharded(args.cards, card)
        else:
            sc = scenes()
            phases = {"c": ("[c] precision", phase_precision, ()),
                      "b": ("[b] kernels vs plain", phase_kernels, (sc,)),
                      "d": ("[d] renders", phase_renders, (sc, card)),
                      "e": ("[e] gradient", phase_gradient, ()),
                      "f": ("[f] kernel vs XLA step", phase_timing,
                            (sc, card))}
            for p in args.phases:
                if p in phases:
                    title, fn, fargs = phases[p]
                    t0 = time.perf_counter()
                    log(title)
                    fn(*fargs)
                    log(f"  ({time.perf_counter() - t0:.1f} s, peak "
                        f"{peak_bytes()} B)")
    except PhaseError:
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
