"""Camera settings files compatible with the reference's text format.

Camera::dump_settings / load_settings (reference src/pathtracer/
camera.cpp:152-186), used by the -c CLI flag (main.cpp:120-122) and the
GUI 'd' key.  Format (whitespace separated):

    hFov vFov ar nClip fClip
    pos[3] targetPos[3]
    phi theta r minR maxR
    c2w[9] (row-major)
    screenW screenH screenDist
    focalDistance lensRadius
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from bidirectional_pathtracing.scene.types import Camera


def load_camera_settings(path: str, lens_radius=None,
                         focal_distance=None) -> Camera:
    vals = [float(x) for x in open(path).read().split()]
    if len(vals) < 28:
        raise ValueError(f"{path}: truncated camera settings file")
    (hfov, vfov, _ar, nclip, fclip) = vals[0:5]
    pos = np.array(vals[5:8])
    # vals[8:11] targetPos, vals[11:16] orbit params
    c2w = np.array(vals[16:25]).reshape(3, 3)
    # vals[25:28] screenW screenH screenDist
    focal, lens = (vals[28], vals[29]) if len(vals) >= 30 else (4.7, 0.0)
    return Camera(
        c2w=jnp.asarray(c2w, jnp.float32),
        pos=jnp.asarray(pos, jnp.float32),
        hfov=jnp.asarray(hfov, jnp.float32),
        vfov=jnp.asarray(vfov, jnp.float32),
        nclip=jnp.asarray(nclip, jnp.float32),
        fclip=jnp.asarray(fclip, jnp.float32),
        lens_radius=jnp.asarray(
            lens if lens_radius is None else lens_radius, jnp.float32),
        focal_distance=jnp.asarray(
            focal if focal_distance is None else focal_distance, jnp.float32),
    )


def dump_camera_settings(camera: Camera, path: str,
                         screen_w: int, screen_h: int,
                         orbit: dict | None = None) -> None:
    """Write the reference's exact dump layout (camera.cpp:152-170).

    `orbit` optionally carries the true orbit state from scene build
    (target/phi/theta/r/min_r/max_r, Application::load placement).  When
    absent, a consistent orbit is derived from (pos, c2w) with r=1 so that
    the reference's compute_position (camera.cpp:123-147) run on the loaded
    state reproduces pos and c2w exactly — not placeholder values.
    """
    hfov = float(camera.hfov)
    vfov = float(camera.vfov)
    pos = np.asarray(camera.pos, np.float64)
    c2w = np.asarray(camera.c2w, np.float64)
    if orbit is not None:
        target = np.asarray(orbit["target"], np.float64)
        phi, theta, r = orbit["phi"], orbit["theta"], orbit["r"]
        min_r, max_r = orbit["min_r"], orbit["max_r"]
    else:
        # dirToCamera = r * (sin phi sin theta, cos phi, sin phi cos theta)
        # equals r * c2w[:,2]; invert with r = 1.
        back = c2w[:, 2]
        phi = float(np.arccos(np.clip(back[1], -1.0, 1.0)))
        theta = float(np.arctan2(back[0], back[2]))
        r = 1.0
        target = pos - back * r
        min_r, max_r = r / 10.0, r * 20.0
    screen_dist = screen_h / (2.0 * np.tan(np.radians(vfov) / 2))
    lines = [
        f"{hfov} {vfov} {screen_w / screen_h} "
        f"{float(camera.nclip)} {float(camera.fclip)}",
        " ".join(f"{v}" for v in pos) + " "
        + " ".join(f"{v}" for v in target),
        f"{phi} {theta} {r} {min_r} {max_r}",
        " ".join(f"{c2w[i, j]}" for i in range(3) for j in range(3)),
        f"{screen_w} {screen_h} {screen_dist}",
        f"{float(camera.focal_distance)} {float(camera.lens_radius)}",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
