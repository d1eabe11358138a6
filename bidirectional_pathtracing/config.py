"""Render configuration.

Single dataclass consumed by the CLI and library API.  Mirrors the reference
AppConfig (reference: src/application/application.h:43-87) plus the hard-coded
knobs surfaced per SURVEY.md section 5 (tile size, BVH leaf size, roulette
parameters, BDPT min subpath length).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Sampling (reference CLI flags: -s, -l, -m; application.h:43-87)
    spp: int = 4                      # -s: camera samples per pixel (ns_aa)
    light_samples: int = 1            # -l: NEE samples per area light (ns_area_light)
    max_ray_depth: int = 5            # -m: maximum bounce depth

    # Frame (reference: -r W H)
    width: int = 480
    height: int = 360

    # Integrator: "bdpt" (reference default, raytraced_renderer.cpp:53) or "pt"
    integrator: str = "bdpt"

    # Unidirectional-only options (reference: pathtracer.cpp)
    direct_hemisphere_sample: bool = False  # -H
    samples_per_batch: int = 32             # -a <batch> (adaptive sampling)
    max_tolerance: float = 0.05             # -a <tol>
    adaptive_sampling: bool = False         # reference disables for BDPT (bidirection.cpp:516)
    pt_reference_nee: bool = True           # replicate the reference's area-light
                                            # NEE estimator quirk (see ops/lights.py)
    bdpt_consistent_camera: bool = False    # False replicates the reference's
                                            # internally inconsistent camera-
                                            # step MIS pricing: the current-
                                            # strategy denominator for the
                                            # camera->first-hit step is pinned
                                            # to 1 (bidirection.cpp:203-210)
                                            # while alternatives price it as
                                            # dir_pdf * G (bidirection.cpp:
                                            # 246-249), bending the partition
                                            # of unity a few percent near the
                                            # view axis.  True = Veach-exact
                                            # pricing (models/bdpt.py
                                            # _mis_tables); same expectation,
                                            # slightly different weights.
    bdpt_reference_t1_mis: bool = False     # reproduce the reference's t=1 MIS
                                            # junction defect (prices the light
                                            # SUBPATH vertex instead of the fresh
                                            # sample, bidirection.cpp:226; see
                                            # models/bdpt.py _mis_weight).  Only
                                            # for reference path replay.
    pt_mis: bool = False                    # EXTENSION beyond the reference: MIS
                                            # the PT's NEE with BSDF-sampled
                                            # emission pickup (power-2 heuristic,
                                            # pbrt 14.3 style).  The reference PT
                                            # relies on NEE alone for direct light
                                            # (pathtracer.cpp:102-165), which
                                            # effectively never captures specular
                                            # reflections of lights on near-delta
                                            # microfacet conductors (huge-f,
                                            # tiny-probability events); this mode
                                            # converges there.  Same expectation
                                            # as the default mode.

    # Thin lens (unidirectional only; reference camera_lens.cpp:22-43)
    lens_radius: float = 0.0          # -b
    focal_distance: float = 4.7       # -d

    # Russian roulette (reference pathtracer.cpp:211-222: active when max_depth==0)
    rr_cpdf: float = 0.3
    rr_depth_cap: int = 20

    # NOTE: the reference declares min_subpath_length (bidirection.h:79) but
    # only references it from commented-out roulette code
    # (bidirection.cpp:87-93) — dead there, so not surfaced here.

    # Acceleration
    accelerator: str = "auto"         # "auto" | "brute" | "bvh"
    bvh_max_leaf_size: int = 4        # reference bvh.h:61
    brute_force_max_tris: int = 2048  # above this many prims, attach a BVH

    # Execution
    samples_per_chunk: int = 0        # camera samples folded into one jitted
                                      # step (0/1 = one pass per step); larger
                                      # chunks enlarge the device wavefront
                                      # without changing the sample stream
    seed: int = 0
    dtype: str = "float32"

    # Environment light (reference: -e path.exr)
    envmap_path: str = ""

    # Output (reference: -f out.png)
    output: str = "out.png"
    save_rate_image: bool = True      # <out>_rate.png heatmap (raytraced_renderer.cpp:730-761)
    save_eye_light_images: bool = False  # BDPT eye/light buffer dumps

    # Cell render (reference: -p x y dx dy)
    cell: tuple | None = None

    def __post_init__(self):
        if self.integrator not in ("bdpt", "pt"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
