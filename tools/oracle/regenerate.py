#!/usr/bin/env python3
"""Regenerate (or check) every tests/golden artifact from the reference.

    python tools/oracle/regenerate.py --check     # compare, don't touch
    python tools/oracle/regenerate.py             # rewrite tests/golden/*

Builds the instrumented oracle (build.sh), exports each .dae through
scene/dump.py, renders the golden configurations single-threaded, and
converts the raw buffers to the committed .npz layout.  Path-dump
fixtures (pd_*.txt) are produced from -s 1 runs for fixed flat pixel ids.

Reproducibility: a given oracle binary is byte-for-byte deterministic
(unseeded per-TU mersenne engines + single-threaded row-major order, see
oracle_main.cpp).  Against goldens produced by an earlier build/compiler
the comparison is Monte-Carlo-statistical: --check reports 8x8 block
relative error, which must stay within the test suite's own tolerances
(2-3.5% mean, see tests/test_bdpt.py) — the documented MC tolerance.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
REFERENCE = os.environ.get("REFERENCE", "/root/reference")
sys.path.insert(0, REPO)

W, H = 120, 90

# (golden name, scene, integrator, spp, depth, light_samples, envmap)
GOLDENS = [
    ("cbspheres_lambertian_bdpt_120x90_64spp_d5", "CBspheres_lambertian",
     "bdpt", 64, 5, 1, False),
    ("cbspheres_bdpt_120x90_64spp_d5", "CBspheres", "bdpt", 64, 5, 1, False),
    ("cbgems_bdpt_120x90_32spp_d8", "CBgems", "bdpt", 32, 8, 1, False),
    ("cbbunny_bdpt_120x90_16spp_d5", "CBbunny", "bdpt", 16, 5, 1, False),
    ("cbspheres_lambertian_pt_120x90_64spp_d5_l4", "CBspheres_lambertian",
     "pt", 64, 5, 4, False),
    ("cbspheres_pt_120x90_64spp_d5_l4", "CBspheres", "pt", 64, 5, 4, False),
    ("cbbunny_pt_120x90_16spp_d5_l4", "CBbunny", "pt", 16, 5, 4, False),
    ("cbspheres_microfacet_pt_120x90_32spp_d5_l4",
     "CBspheres_microfacet_al_ag", "pt", 32, 5, 4, False),
    ("bunny_unlit_env_pt_120x90_16spp", "bunny_unlit", "pt", 16, 5, 4, True),
    ("cbspheres_refract_pt_120x90_32spp_d5_l4", "CBspheres_refract",
     "pt", 32, 5, 4, False),
    ("cbspheres_refract_bdpt_120x90_32spp_d5", "CBspheres_refract",
     "bdpt", 32, 5, 1, False),
]

# (fixture tag, scene, flat pixel ids)  — -s 1, depth 5
PD_FIXTURES = [
    ("pd_cbl", "CBspheres_lambertian", [1234, 2222, 3000, 5500, 7777, 9200]),
    ("pd_cbs", "CBspheres", [1234, 3000, 5500, 7777, 9200]),
]


def run(cmd, **kw):
    print("+", " ".join(str(c) for c in cmd))
    subprocess.run([str(c) for c in cmd], check=True, **kw)


def read_bin(path):
    raw = open(path, "rb").read()
    w, h = np.frombuffer(raw[:8], np.int32)
    return np.frombuffer(raw[8:], np.float32).reshape(-1, h, w, 3).copy()


def write_env(path):
    from tests.test_envlight import _synthetic_env
    img = _synthetic_env()
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(np.array([w, h], np.int32).tobytes())
        f.write(img.astype(np.float32).tobytes())


def block_err(a, b, nb=8, floor=0.05):
    bh, bw = a.shape[0] // nb, a.shape[1] // nb
    ba = a[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))
    bb = b[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))
    return np.abs(ba - bb) / (np.abs(bb) + floor)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", default="/tmp/oracle_build")
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "golden"))
    ap.add_argument("--check", action="store_true",
                    help="render into a scratch dir and report block error "
                         "vs the committed goldens instead of rewriting")
    ap.add_argument("--only", default=None,
                    help="substring filter: only regenerate goldens whose "
                         "name contains this (pd fixtures skipped)")
    args = ap.parse_args()
    goldens = [g for g in GOLDENS
               if args.only is None or args.only in g[0]]
    pd_fixtures = PD_FIXTURES if args.only is None else []

    run(["bash", os.path.join(HERE, "build.sh"), args.build])
    oracle = os.path.join(args.build, "oracle")
    work = os.path.join(args.build, "work")
    os.makedirs(work, exist_ok=True)

    from bidirectional_pathtracing.scene.dump import dump_scene
    scenes = {s for _, s, *_ in goldens} | {s for _, s, _ in pd_fixtures}
    for s in scenes:
        dump_scene(f"{REFERENCE}/dae/sky/{s}.dae",
                   os.path.join(work, s + ".txt"))

    env_bin = os.path.join(work, "env.bin")
    write_env(env_bin)

    out_dir = work if args.check else args.out
    failures = []
    for name, scene, integ, spp, depth, ls, env in goldens:
        prefix = os.path.join(work, name)
        cmd = [oracle, os.path.join(work, scene + ".txt"), W, H, spp, depth,
               prefix, "--integrator", integ, "-l", ls]
        if env:
            cmd += ["--envmap", env_bin]
        run(cmd)
        bufs = read_bin(prefix + ".bin")
        if integ == "bdpt":
            data = dict(eye=bufs[0], light=bufs[1],
                        combined=bufs[0] + bufs[1])
        else:
            data = dict(combined=bufs[0])
        target = os.path.join(out_dir, name + ".npz")
        np.savez(target, **data)
        if args.check:
            ref = np.load(os.path.join(args.out, name + ".npz"))
            for k in data:
                e = block_err(data[k], ref[k],
                              floor=0.05 if k != "light" else 0.5)
                status = "OK" if e.mean() < 0.05 else "DIVERGED"
                if e.mean() >= 0.05:
                    failures.append((name, k, e.mean()))
                print(f"  {name}[{k}]: block err mean {e.mean():.4f} "
                      f"max {e.max():.4f} {status}")

    for tag, scene, pixels in pd_fixtures:
        prefix = os.path.join(out_dir, tag)
        run([oracle, os.path.join(work, scene + ".txt"), W, H, 1, 5,
             prefix, "--pixels", ",".join(str(p) for p in pixels)])
        os.remove(prefix + ".bin")

    if args.check:
        print("pd fixtures regenerated into", out_dir,
              "(validated by tests/test_bdpt_paths.py replay)")
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("all goldens within MC tolerance")


if __name__ == "__main__":
    main()
