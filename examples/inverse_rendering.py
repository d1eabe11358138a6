"""Inverse rendering: recover albedos (and light scale) by gradient descent.

Demonstrates the differentiable-render path (BASELINE "differentiable
albedo/emission optimization"):

  --mode box (default): render a target Cornell box with BDPT, perturb the
    material table, recover it by minimising an L2 image loss with Adam —
    gradients flow through the estimator via the detached-sampling rule.

  --mode envlight (BASELINE stretch goal): an OPEN scene (ground + two
    spheres) lit only by an HDR environment map, rendered with the
    unidirectional tracer (env light NEE, like the reference's -e path,
    raytraced_renderer.cpp:117-119).  Recovers the diffuse albedos AND the
    envmap emission scale jointly.  Uses exr/ennis.exr when a real file is
    present; the repo snapshot ships git-lfs stubs, so it falls back to a
    synthetic HDR sky (documented stand-in).

Run:  python examples/inverse_rendering.py [--mode envlight] [--steps 60]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.models import bdpt
from bidirectional_pathtracing.scene.procedural import make_cornell_box


def _env_image():
    """ennis.exr when real, else a synthetic HDR sky (sun blob + gradient)."""
    path = "/root/reference/exr/ennis.exr"
    try:
        from bidirectional_pathtracing.utils.exr import read_exr
        img = read_exr(path)
        if img.shape[0] >= 8:
            print(f"using {path}")
            return np.asarray(img, np.float32)
    except Exception:
        pass
    print("exr/ennis.exr is a git-lfs stub; using a synthetic HDR sky")
    hh, ww = 32, 64
    y, x = np.mgrid[0:hh, 0:ww]
    theta = (y + 0.5) / hh * np.pi
    img = np.zeros((hh, ww, 3), np.float32)
    img[..., 2] = 0.5 + 0.4 * np.cos(theta)
    img[..., 1] = 0.35 + 0.2 * np.cos(theta)
    img[..., 0] = 0.25 + 0.1 * np.sin(theta)
    blob = np.exp(-(((x - ww / 4) / 2.5) ** 2 + ((y - hh / 4) / 2.5) ** 2))
    img += 30.0 * blob[..., None] * np.array([1.0, 0.95, 0.8], np.float32)
    return img


def _open_scene():
    """Ground quad + two diffuse spheres, no analytic lights."""
    from bidirectional_pathtracing.scene.procedural import _quad
    from bidirectional_pathtracing.scene.types import (
        Camera, MAT_DIFFUSE, Scene, make_geometry, make_lights,
        make_materials)
    s = 4.0
    tri_p, tri_n = _quad(np.array([-s, 0, s]), np.array([s, 0, s]),
                         np.array([s, 0, -s]), np.array([-s, 0, -s]),
                         np.array([0.0, 1.0, 0.0]))
    tri_mat = np.zeros(len(tri_p), np.int32)
    geometry = make_geometry(
        np.asarray(tri_p), np.asarray(tri_n), tri_mat,
        sph_c=np.array([[-0.8, 0.6, 0.0], [0.9, 0.45, 0.6]]),
        sph_r=np.array([0.6, 0.45]),
        sph_mat=np.array([1, 2], np.int32))
    materials = make_materials([
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.55, 0.5, 0.45])},
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.7, 0.25, 0.2])},
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.2, 0.35, 0.7])},
    ])
    pos = np.array([0.0, 1.6, 5.0])
    back = pos - np.array([0.0, 0.7, 0.0])
    back = back / np.linalg.norm(back)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    camera = Camera(
        c2w=jnp.asarray(np.stack([right, up, back], axis=1), jnp.float32),
        pos=jnp.asarray(pos, jnp.float32),
        hfov=jnp.float32(50.0), vfov=jnp.float32(38.0),
        nclip=jnp.float32(0.1), fclip=jnp.float32(100.0),
        lens_radius=jnp.float32(0.0), focal_distance=jnp.float32(4.7))
    return Scene(geometry=geometry, materials=materials,
                 lights=make_lights([]), camera=camera)


def run_envlight(args):
    from bidirectional_pathtracing.core import rng
    from bidirectional_pathtracing.models import pathtracer as pt
    from bidirectional_pathtracing.ops import envlight as envops

    w, h = args.size
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=w, height=h,
                       integrator="pt", light_samples=1)
    base = _open_scene()
    env = envops.build_envmap(_env_image())
    pix = jnp.arange(w * h, dtype=jnp.int32)

    def render_once(albedo, log_scale, key):
        env_scaled = env._replace(data=env.data * jnp.exp(log_scale))
        s = base._replace(
            materials=base.materials._replace(albedo=albedo),
            envmap=env_scaled)
        keys = rng.lane_keys(key, pix)
        o, d = pt.sample_camera_rays(s, keys, w, h, pix, cfg)
        return pt.trace_radiance(s, o, d, keys, cfg)

    true_albedo = base.materials.albedo
    key0 = jax.random.key(7)
    # common random numbers: per-key targets so the loss is exactly zero at
    # the true parameters (kills the MC noise floor in the gradients)
    n_keys = 4
    target_keys = jnp.stack(
        [jax.random.fold_in(key0, i) for i in range(n_keys)])
    targets = jnp.stack([
        jax.jit(render_once)(true_albedo, jnp.float32(0.0), target_keys[i])
        for i in range(n_keys)])

    guess_a = jnp.clip(true_albedo + jnp.asarray(
        [[0.25, -0.2, 0.15], [-0.3, 0.25, 0.2], [0.3, -0.15, -0.3]]),
        0.05, 0.95)
    guess_s = jnp.float32(np.log(0.4))   # envmap 2.5x too dim

    import optax
    opt = optax.adam(args.lr)
    params = {"albedo": guess_a, "log_scale": guess_s}
    state = opt.init(params)

    @jax.jit
    def step(params, state, key, target):
        def loss_fn(p):
            img = render_once(p["albedo"], p["log_scale"], key)
            return jnp.mean((img - target) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, state = opt.update(g, state)
        params = jax.tree.map(lambda a, u: a + u, params, upd)
        params["albedo"] = jnp.clip(params["albedo"], 0.0, 1.0)
        return params, state, loss

    def errs(p):
        return (float(jnp.abs(p["albedo"] - true_albedo).max()),
                float(jnp.abs(p["log_scale"])))

    ea0, es0 = errs(params)
    t0 = time.time()
    for i in range(args.steps):
        k = i % n_keys
        params, state, loss = step(params, state, target_keys[k],
                                   targets[k])
        if i % 10 == 0 or i == args.steps - 1:
            ea, es = errs(params)
            print(f"step {i:3d}  loss {float(loss):.5f}  albedo err "
                  f"{ea:.4f}  |log env scale| {es:.4f}")
    ea1, es1 = errs(params)
    print(f"done in {time.time() - t0:.1f}s: albedo {ea0:.3f} -> {ea1:.3f}, "
          f"log env scale {es0:.3f} -> {es1:.3f}")
    assert ea1 < ea0 * 0.5 and es1 < es0 * 0.5, "failed to converge"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--size", type=int, nargs=2, default=[48, 36])
    ap.add_argument("--mode", choices=["box", "envlight"], default="box")
    args = ap.parse_args()

    if args.mode == "envlight":
        run_envlight(args)
        return

    w, h = args.size
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=w, height=h,
                       integrator="bdpt")
    scene = make_cornell_box()
    pix = jnp.arange(w * h, dtype=jnp.int32)

    def render_once(albedo, key):
        s = scene._replace(materials=scene.materials._replace(albedo=albedo))
        eye, light = bdpt.sample_pass(s, key, w, h, pix, cfg)
        return eye + light

    target_albedo = scene.materials.albedo
    # only diffuse materials consume albedo; measure recovery there
    diffuse_mask = np.asarray(scene.materials.kind) == 0
    key0 = jax.random.key(123)
    # common random numbers: per-key targets -> zero loss at the optimum
    n_keys = 4
    target_keys = jnp.stack(
        [jax.random.fold_in(key0, i) for i in range(n_keys)])
    targets = jnp.stack([jax.jit(render_once)(target_albedo, target_keys[i])
                         for i in range(n_keys)])

    # start from a wrong guess
    guess = jnp.clip(target_albedo + 0.35 * jnp.sin(
        jnp.arange(target_albedo.size, dtype=jnp.float32)
    ).reshape(target_albedo.shape), 0.05, 0.95)

    import optax
    opt = optax.adam(args.lr)
    state = opt.init(guess)

    @jax.jit
    def step(albedo, state, key, target):
        def loss_fn(a):
            img = render_once(a, key)
            return jnp.mean((img - target) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(albedo)
        upd, state = opt.update(g, state)
        albedo = jnp.clip(albedo + upd, 0.0, 1.0)
        return albedo, state, loss

    def albedo_err(a):
        return float(jnp.abs(a - target_albedo)[diffuse_mask].max())

    err0 = albedo_err(guess)
    t0 = time.time()
    albedo = guess
    for i in range(args.steps):
        k = i % n_keys
        albedo, state, loss = step(albedo, state, target_keys[k],
                                   targets[k])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.5f}  "
                  f"max diffuse albedo err {albedo_err(albedo):.4f}")
    err1 = albedo_err(albedo)
    print(f"done in {time.time() - t0:.1f}s: albedo error {err0:.3f} -> "
          f"{err1:.3f}")
    assert err1 < err0 * 0.5, "optimization failed to converge"


if __name__ == "__main__":
    main()
