"""Benchmark suite: BDPT throughput on three BASELINE scenes.

Prints ONE JSON line (the headline CBspheres metric, comparable to the
reference's 17,953 camera samples/s implied by report.md:159); the full
multi-scene results incl. measured Mrays/s go to build/bench_details.json
and stderr.

Scenes:
  CBspheres 480x360 d5  — 14 prims: measures the BDPT connection/MIS
                          machinery (brute-force intersection)
  CBbunny   480x360 d5  — 28.5k tris: the BVH walk
  CBgems    480x360 d8  — depth-8 compile + delta-heavy paths
  CBlucy_standin d5     — 457k tris (CBbunny, bunny Loop-subdivided 2x):
                          the BVH walk's scaling row
"""

import json
import os
import sys
import time


REF_SAMPLES_PER_S = 480 * 360 * 32 / 308.0


def bench_scene(name, scene_path, depth, spp, chunk):
    import jax
    import jax.numpy as jnp
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import (
        _bdpt_step_chunk, _trace_cfg)

    width, height = 480, 360
    if os.path.isdir("/root/reference"):
        from bidirectional_pathtracing.scene.build import load_scene
        if name == "CBlucy_standin":
            # the 457k-tri large-scene row (CBlucy.dae is a missing blob;
            # stand-in = CBbunny with the bunny Loop-subdivided twice,
            # walls intact -- same scene as tools/flagship_render.py lucy)
            scene, aux = load_scene(scene_path, width, height,
                                    mesh_ops=("upsample", "upsample"),
                                    mesh_ops_min_tris=1000)
        else:
            scene, aux = load_scene(scene_path, width, height)
        n_tris = aux["num_tris"]
    else:
        from bidirectional_pathtracing.scene.procedural import (
            make_cornell_box)
        scene = make_cornell_box(sphere_materials=("mirror", "glass"))
        n_tris = 12

    cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=width,
                       height=height, integrator="bdpt")
    # the EXACT dispatch the render() driver issues (same tcfg hash, same
    # operand signature AND shardings — a NamedSharding device_put here
    # would flip the compile-cache key vs the CLI/flagship renders)
    tcfg = _trace_cfg(cfg)
    inv = jnp.float32(1.0 / spp)
    key = jax.random.key(0)

    def step(base):
        return _bdpt_step_chunk(scene, key, jnp.int32(base), tcfg, width,
                                height, chunk, inv)

    t0 = time.perf_counter()     # warmup/compile
    jax.block_until_ready(step(0))
    compile_s = time.perf_counter() - t0

    n_chunks = spp // chunk
    rays_total = 0.0
    t0 = time.perf_counter()
    for i in range(n_chunks):
        eye, light, rays = step(i * chunk)
        rays_total += float(rays)
    jax.block_until_ready((eye, light))
    dt = time.perf_counter() - t0

    samples = width * height * n_chunks * chunk
    res = {
        "scene": name,
        "tris": int(n_tris),
        "depth": depth,
        "spp": samples // (width * height),
        "wall_s": round(dt, 3),
        "compile_s": round(compile_s, 1),
        "samples_per_s": round(samples / dt, 1),
        "rays": rays_total,
        "mrays_per_s": round(rays_total / dt / 1e6, 3),
        "rays_per_sample": round(rays_total / samples, 2),
    }
    print(f"[bench] {json.dumps(res)}", file=sys.stderr)
    return res


def main():
    from bidirectional_pathtracing.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    only = sys.argv[1] if len(sys.argv) > 1 else None
    runs = [
        ("CBspheres", "/root/reference/dae/sky/CBspheres.dae", 5, 32, 8),
        ("CBbunny", "/root/reference/dae/sky/CBbunny.dae", 5, 8, 8),
        ("CBgems", "/root/reference/dae/sky/CBgems.dae", 8, 8, 8),
        ("CBlucy_standin", "/root/reference/dae/sky/CBbunny.dae", 5, 8, 8),
    ]
    results = []
    printed = False
    for name, path, depth, spp, chunk in runs:
        if only and name != only:
            continue
        try:
            results.append(bench_scene(name, path, depth, spp, chunk))
        except Exception as e:  # keep the headline metric alive
            print(f"[bench] {name} failed: {e}", file=sys.stderr)
        # emit the headline line as soon as it exists, so a timeout on the
        # bigger scenes cannot lose the round's metric
        if not printed and results and results[0]["scene"] == "CBspheres":
            sps = results[0]["samples_per_s"]
            print(json.dumps({
                "metric": "bdpt_camera_samples_per_s_480x360_d5_CBspheres",
                "value": sps,
                "unit": "samples/s",
                "vs_baseline": round(sps / REF_SAMPLES_PER_S, 2),
            }), flush=True)
            printed = True
        os.makedirs("build", exist_ok=True)
        with open("build/bench_details.json", "w") as f:
            json.dump(results, f, indent=1)

    if not printed:
        if not results:
            sys.exit(1)
        sps = results[0]["samples_per_s"]
        print(json.dumps({
            "metric": f"bdpt_camera_samples_per_s_480x360_"
                      f"{results[0]['scene']}",
            "value": sps,
            "unit": "samples/s",
            "vs_baseline": round(sps / REF_SAMPLES_PER_S, 2),
        }))


if __name__ == "__main__":
    main()
