"""Command-line renderer mirroring the reference CLI.

Reference flags (src/application/main.cpp:24-38):
  -s <spp>            camera samples per pixel
  -l <n>              samples per area light (unidirectional NEE)
  -t <n>              threads (here: informational; devices come from JAX)
  -m <depth>          max ray depth
  -e <file.exr>       environment map
  -b <lens radius>    thin-lens aperture (unidirectional)
  -d <focal dist>     focal distance
  -f <out.png>        output file (headless render)
  -r <W> <H>          frame size
  -p <x> <y> <dx> <dy> cell render
  -c <file>           camera settings file
  -a <batch> <tol>    adaptive sampling
  -H                  hemisphere direct sampling
plus new:
  --integrator {bdpt,pt}    (the reference hard-wires BDPT,
                             raytraced_renderer.cpp:53)
  --seed N
  --save-buffers            also write <out>_eye.png / <out>_light.png

Usage: python -m bidirectional_pathtracing.cli [flags] scene.dae
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="bdpt", description="bidirectional path tracer")
    ap.add_argument("scene", help=".dae scene file")
    ap.add_argument("-s", dest="spp", type=int, default=4)
    ap.add_argument("-l", dest="light_samples", type=int, default=1)
    ap.add_argument("-t", dest="threads", type=int, default=0,
                    help="ignored (JAX devices are used); kept for parity")
    ap.add_argument("-m", dest="max_depth", type=int, default=5)
    ap.add_argument("-e", dest="envmap", default="")
    ap.add_argument("-b", dest="lens_radius", type=float, default=0.0)
    ap.add_argument("-d", dest="focal_distance", type=float, default=4.7)
    ap.add_argument("-f", dest="output", default="out.png")
    ap.add_argument("-r", dest="size", type=int, nargs=2,
                    default=[480, 360], metavar=("W", "H"))
    ap.add_argument("-p", dest="cell", type=int, nargs=4, default=None,
                    metavar=("X", "Y", "DX", "DY"))
    ap.add_argument("-c", dest="camera_settings", default="")
    ap.add_argument("-a", dest="adaptive", type=float, nargs=2, default=None,
                    metavar=("BATCH", "TOL"))
    ap.add_argument("-H", dest="hemisphere", action="store_true")
    ap.add_argument("--integrator", choices=["bdpt", "pt"], default="bdpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-buffers", action="store_true")
    ap.add_argument("--no-rate-image", action="store_true",
                    help="skip the <out>_rate.png sampling-rate heatmap")
    ap.add_argument("--accelerator", choices=["auto", "brute", "bvh"],
                    default="auto",
                    help="intersection backend (RenderConfig.accelerator)")
    ap.add_argument("--bvh-leaf-size", type=int, default=4,
                    help="BVH max primitives per leaf (reference bvh.h:61)")
    ap.add_argument("--brute-max-tris", type=int, default=2048,
                    help="auto mode: stay brute-force below this many prims")
    ap.add_argument("--samples-per-chunk", type=int, default=0,
                    help="camera sample passes folded into one device step")
    ap.add_argument("--dump-camera", default="", metavar="FILE",
                    help="write camera settings file (the reference GUI 'd' "
                         "key, camera.cpp:152-170) and continue")
    ap.add_argument("--stats-json", default="",
                    help="write render stats to this JSON file")
    ap.add_argument("--autofocus", type=float, nargs=2, default=None,
                    metavar=("X", "Y"),
                    help="autofocus on pixel (x, y) before rendering "
                         "(the reference's right-click autofocus, "
                         "pathtracer.cpp:342-349)")
    ap.add_argument("--envmap-debug", action="store_true",
                    help="write probability_debug.png next to the output "
                         "(EnvironmentLight::save_probability_debug)")
    ap.add_argument("--visualize-bvh", nargs="?", const="", default=None,
                    metavar="NAV",
                    help="write <out>_bvh.png visualizing the BVH (the "
                         "reference's VISUALIZE mode); NAV is a walk string "
                         "of l/r/u applied from the root, mirroring the "
                         "arrow keys (raytraced_renderer.cpp:560-574)")
    ap.add_argument("--bvh-rays", type=int, default=0, metavar="STRIDE",
                    help="overlay primary rays every STRIDE pixels on the "
                         "BVH visualization (yellow=hit red=miss, "
                         "raytraced_renderer.cpp:439-463); 0 = off")
    ap.add_argument("--upsample", type=int, default=0, metavar="N",
                    help="apply N rounds of Loop subdivision to every mesh "
                         "before rendering (the reference EDIT-mode 'u' key)")
    ap.add_argument("--downsample", type=int, default=0, metavar="N",
                    help="apply N rounds of quadric simplification "
                         "(EDIT-mode 'd')")
    ap.add_argument("--resample", type=int, default=0, metavar="N",
                    help="apply N rounds of isotropic remeshing "
                         "(EDIT-mode 'i')")
    return ap


def main(argv=None):
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.visualize_bvh and (set(args.visualize_bvh) - set("lru")):
        ap.error(f"--visualize-bvh: invalid walk {args.visualize_bvh!r} "
                 "(use only l/r/u)")

    from bidirectional_pathtracing.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()   # repeat renders of a scene shape skip compiling

    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils import image as img
    from bidirectional_pathtracing.utils.render import render

    w, h = args.size
    cfg = RenderConfig(
        spp=args.spp, light_samples=args.light_samples,
        max_ray_depth=args.max_depth, width=w, height=h,
        integrator=args.integrator,
        direct_hemisphere_sample=args.hemisphere,
        lens_radius=args.lens_radius, focal_distance=args.focal_distance,
        samples_per_batch=int(args.adaptive[0]) if args.adaptive else 32,
        max_tolerance=args.adaptive[1] if args.adaptive else 0.05,
        adaptive_sampling=(args.adaptive is not None
                           and args.integrator == "pt"),
        envmap_path=args.envmap, output=args.output, seed=args.seed,
        cell=tuple(args.cell) if args.cell else None,
        accelerator=args.accelerator,
        bvh_max_leaf_size=args.bvh_leaf_size,
        brute_force_max_tris=args.brute_max_tris,
        samples_per_chunk=args.samples_per_chunk,
        save_rate_image=not args.no_rate_image,
        save_eye_light_images=args.save_buffers,
    )

    print(f"[bdpt] loading scene {args.scene}", file=sys.stderr)
    t0 = time.perf_counter()
    mesh_ops = (["upsample"] * args.upsample
                + ["downsample"] * args.downsample
                + ["resample"] * args.resample)
    scene, aux = load_scene(args.scene, w, h,
                            lens_radius=cfg.lens_radius,
                            focal_distance=cfg.focal_distance,
                            accel=cfg.accelerator,
                            brute_force_max_tris=cfg.brute_force_max_tris,
                            bvh_max_leaf_size=cfg.bvh_max_leaf_size,
                            mesh_ops=tuple(mesh_ops))
    if args.envmap:
        from bidirectional_pathtracing.ops import envlight
        from bidirectional_pathtracing.utils.exr import read_exr
        data = read_exr(args.envmap)
        scene = scene._replace(envmap=envlight.build_envmap(data))
        if args.envmap_debug:
            import os
            dbg = os.path.join(os.path.dirname(args.output) or ".",
                               "probability_debug.png")
            envlight.save_probability_debug(scene.envmap, dbg)
            print(f"[bdpt] saved {dbg}", file=sys.stderr)
    print(f"[bdpt] scene: {aux['num_tris']} tris, "
          f"{aux['num_spheres']} spheres, loaded in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    if args.camera_settings:
        from bidirectional_pathtracing.scene.camera_file import (
            load_camera_settings)
        scene = scene._replace(camera=load_camera_settings(
            args.camera_settings, lens_radius=cfg.lens_radius,
            focal_distance=cfg.focal_distance))
        print(f"[bdpt] loaded camera settings from "
              f"{args.camera_settings}", file=sys.stderr)

    if args.dump_camera:
        from bidirectional_pathtracing.scene.camera_file import (
            dump_camera_settings)
        dump_camera_settings(scene.camera, args.dump_camera, w, h,
                             orbit=aux.get("orbit"))
        print(f"[bdpt] dumped camera settings to {args.dump_camera}",
              file=sys.stderr)

    if args.autofocus:
        import jax.numpy as jnp
        from bidirectional_pathtracing.utils.render import autofocus
        fd = autofocus(scene, args.autofocus[0], args.autofocus[1], w, h)
        scene = scene._replace(camera=scene.camera._replace(
            focal_distance=jnp.float32(fd)))
        print(f"[bdpt] autofocus: focal distance = {fd:.4f}",
              file=sys.stderr)

    # Ctrl-C = cooperative stop: finish the in-flight pass, save what we
    # have (the reference's stop + save flow); a second Ctrl-C hard-exits.
    import signal
    import threading
    cancel = threading.Event()

    def _on_sigint(sig, frame):
        if cancel.is_set():
            raise KeyboardInterrupt
        cancel.set()
        print("[bdpt] stopping after this pass (Ctrl-C again to abort)",
              file=sys.stderr)

    prev_handler = signal.signal(signal.SIGINT, _on_sigint)
    try:
        res = render(scene, cfg, cancel=cancel)
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    st = res.stats
    print(f"[bdpt] rendered {st['camera_samples']} samples in "
          f"{st['wall_time_s']:.2f}s "
          f"({st['camera_samples_per_s']:.0f} samples/s, "
          f"{st['mrays_per_s']:.2f} Mrays/s measured, "
          f"{st['rays_per_sample']:.1f} rays/sample)", file=sys.stderr)

    img.save_image(args.output, res.combined)
    if cfg.save_rate_image:
        img.save_sampling_rate_image(args.output, res.sample_counts, cfg.spp)
    if cfg.save_eye_light_images and res.eye is not None:
        img.save_image(args.output[:-4] + "_eye.png", res.eye)
        img.save_image(args.output[:-4] + "_light.png", res.light)
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(st, f)
    if args.visualize_bvh is not None:
        from bidirectional_pathtracing.utils.bvh_vis import (
            BVHVisualizer, collect_ray_log, save_visualization)
        vis = BVHVisualizer(scene)
        vis.navigate(args.visualize_bvh)
        ray_log = (collect_ray_log(scene, w, h, args.bvh_rays)
                   if args.bvh_rays else None)
        imgv = vis.render(w, h, ray_log=ray_log, ray_stride=1)
        bvh_path = (args.output[:-4] if args.output.endswith(".png")
                    else args.output) + "_bvh.png"
        save_visualization(bvh_path, imgv)
        print(f"[bdpt] saved {bvh_path} (node {vis.current()})",
              file=sys.stderr)
    print(f"[bdpt] saved {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
