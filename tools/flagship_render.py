"""Flagship parity renders: 480x360 @ 128spp BDPT on the chip, compared
block-by-block against the reference's committed goldens
(/root/reference/assets/CB{spheres,gems}_bdpt_128.png, README.md:5-9).

    python tools/flagship_render.py [scene ...]
    # default: spheres gems bunny lucy; "lucy" renders the 457k-tri
    # Loop-subdivided bunny (the CBlucy stand-in: CBlucy.dae is a missing
    # blob per /root/reference/.MISSING_LARGE_BLOBS) — the end-to-end
    # large-scene convergence demonstration.

Writes artifacts/CB<scene>_bdpt_128.png (+ _eye/_light) and
artifacts/FLAGSHIP.json with a UNIFORM schema per row: 128 spp, compile_s,
wall time, measured Mrays/s, and 8x8
block error in tonemapped sRGB space against a parity referee — the
reference's committed golden PNG when one exists (spheres, gems), else a
converged same-spp MIS-PT render (pt_mis + pt_reference_nee=False, the
cross-integrator referee of tests/test_microfacet.py) for bunny/lucy,
whose scenes have no committed reference golden.
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")

import numpy as np

SCENES = {
    "spheres": ("CBspheres", 5, 128),
    "gems": ("CBgems", 8, 128),
    "bunny": ("CBbunny", 5, 128),
    "lucy": ("CBbunny_up2", 5, 128),
}


def _load_lucy_standin(width, height):
    """CBbunny with the bunny mesh Loop-subdivided twice via meshedit
    (28.5k -> ~457k tris).  Only meshes >=1000 tris are subdivided: the
    Cornell-box walls are open sheets whose boundaries shrink under Loop
    subdivision (they rendered as ovals in the first r03 artifact)."""
    from bidirectional_pathtracing.scene.build import load_scene
    return load_scene("/root/reference/dae/sky/CBbunny.dae", width, height,
                      mesh_ops=("upsample", "upsample"),
                      mesh_ops_min_tris=1000)


def block_err(a, b, nb=8, floor=8.0):
    """Mean abs block error between two uint8 [H,W,3] images, relative."""
    bh, bw = a.shape[0] // nb, a.shape[1] // nb
    ba = a[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).astype(
        np.float64).mean((1, 3))
    bb = b[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).astype(
        np.float64).mean((1, 3))
    return np.abs(ba - bb) / (bb + floor)


def main():
    names = sys.argv[1:] or ["spheres", "gems", "bunny", "lucy"]
    os.makedirs("artifacts", exist_ok=True)

    import jax

    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils import image as img
    from bidirectional_pathtracing.utils.png import read_png
    from bidirectional_pathtracing.utils.render import render

    from bidirectional_pathtracing.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()

    # merge into the existing artifact so single-scene reruns don't drop
    # the other scenes' rows
    results = {}
    if os.path.exists("artifacts/FLAGSHIP.json"):
        with open("artifacts/FLAGSHIP.json") as f:
            results = json.load(f)
    for name in names:
        scene_name, depth, spp = SCENES[name]
        if name == "lucy":
            scene, aux = _load_lucy_standin(480, 360)
        else:
            scene, aux = load_scene(
                f"/root/reference/dae/sky/{scene_name}.dae", 480, 360)
        cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=480,
                           height=360, integrator="bdpt")
        # Warm the exact step render() dispatches (same tcfg/chunk/operand
        # signature) so wall_time_s below is steady-state render time, with
        # the one-off compile reported separately.
        import jax.numpy as jnp
        from bidirectional_pathtracing.utils.render import (
            _auto_chunk, _bdpt_step_chunk, _trace_cfg)
        tcfg = _trace_cfg(cfg)
        chunk = _auto_chunk(cfg)
        inv = jnp.float32(1.0 / cfg.spp)

        def step():
            out = _bdpt_step_chunk(scene, jax.random.key(cfg.seed),
                                   jnp.int32(0), tcfg, 480, 360, chunk, inv)
            jax.block_until_ready(out)

        t0 = time.perf_counter()
        step()
        warm_s = time.perf_counter() - t0
        # the warm-up above executed one full chunk after compiling; time
        # an identical dispatch and subtract so compile_s is the compile
        t0 = time.perf_counter()
        step()
        compile_s = warm_s - (time.perf_counter() - t0)
        t0 = time.perf_counter()
        res = render(scene, cfg)
        out = f"artifacts/{scene_name}_bdpt_{spp}.png"
        img.save_image(out, res.combined)
        img.save_image(out[:-4] + "_eye.png", res.eye)
        img.save_image(out[:-4] + "_light.png", res.light)

        row = {
            "spp": spp,
            "compile_s": round(compile_s, 1),
            "wall_time_s": round(res.stats["wall_time_s"], 1),
            "samples_per_s": round(res.stats["camera_samples_per_s"], 1),
            "mrays_per_s": round(res.stats["mrays_per_s"], 3),
            "rays_per_sample": round(res.stats["rays_per_sample"], 2),
            "tris": aux["num_tris"],
        }
        mine = read_png(out)[..., :3]
        ref_png = f"/root/reference/assets/{scene_name}_bdpt_128.png"
        if os.path.exists(ref_png) and spp == 128:
            ref = read_png(ref_png)[..., :3]
            row["referee"] = "reference_png"
        else:
            # no committed reference golden for this scene: referee with a
            # converged same-spp MIS-PT render (cross-integrator parity;
            # the two estimators share no strategy weights, so block-level
            # agreement is a real convergence check)
            cfg_ref = RenderConfig(
                spp=spp, max_ray_depth=depth, width=480, height=360,
                integrator="pt", light_samples=2, pt_reference_nee=False,
                pt_mis=True)
            res_ref = render(scene, cfg_ref)
            ref_out = f"artifacts/{scene_name}_ptmis_{spp}.png"
            img.save_image(ref_out, res_ref.combined)
            ref = read_png(ref_out)[..., :3]
            row["referee"] = f"pt_mis_{spp}"
        e = block_err(mine, ref)
        row["block_err_mean"] = round(float(e.mean()), 4)
        row["block_err_max"] = round(float(e.max()), 4)
        results[scene_name] = row
        print(scene_name, row, flush=True)

        with open("artifacts/FLAGSHIP.json", "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
