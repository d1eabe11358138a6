"""MIS partition-of-unity: for a fixed transport path, the weights of all
(s,t) strategies that can generate it must sum to 1 (Veach power
heuristic).  This is the core invariant that makes the converged BDPT image
independent of the weighting (SURVEY.md section 7 step 5 acceptance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.core.math import PI, make_coord_space, to_local
from bidirectional_pathtracing.core import samplers
from bidirectional_pathtracing.models import bdpt
from bidirectional_pathtracing.models.bdpt import Subpath
from bidirectional_pathtracing.ops import camera_ops
from bidirectional_pathtracing.scene.procedural import make_cornell_box

NV = 6


def _subpath(verts, dir_pdf, p1):
    """verts: list of (pos, n, mat).  Slot 1 = first vertex."""
    k = len(verts)
    pos = np.zeros((1, NV + 2, 3), np.float32)
    n = np.zeros((1, NV + 2, 3), np.float32)
    alpha = np.ones((1, NV + 2, 3), np.float32)
    p = np.ones((1, NV + 2), np.float32)
    mat = np.full((1, NV + 2), -1, np.int32)
    valid = np.zeros((1, NV + 2), bool)
    for i, (vp, vn, vm) in enumerate(verts, start=1):
        pos[0, i] = vp
        n[0, i] = vn
        mat[0, i] = vm
        valid[0, i] = True
    p[0, 1] = p1
    return Subpath(pos=jnp.asarray(pos), n=jnp.asarray(n),
                   alpha=jnp.asarray(alpha), p=jnp.asarray(p),
                   mat=jnp.asarray(mat), valid=jnp.asarray(valid),
                   dir_pdf=jnp.asarray([dir_pdf], jnp.float32))


@pytest.mark.parametrize("path_spec", ["floor_back", "wall_floor_back"])
def test_mis_weights_sum_to_one(path_spec):
    _check_partition(path_spec, consistent_camera=False, tol=0.05)


@pytest.mark.parametrize("path_spec", ["floor_back", "wall_floor_back"])
def test_mis_weights_sum_to_one_microfacet(path_spec):
    """Partition of unity over paths with MICROFACET interior vertices —
    the one BSDF whose BDPT behavior has no reference oracle (the
    reference asserts, advanced_bsdf.cpp:144-148).  Exercises the
    wo-independent MIS proxy pdf (ops/bsdf.py sample_pdf): with the
    true-but-wo-starved NDF pdf this sum is #strategies, not 1."""
    _check_partition(path_spec, consistent_camera=True, tol=2e-3,
                     interior_mat=7)  # procedural id 7 = microfacet Al


@pytest.mark.parametrize("path_spec", ["floor_back", "wall_floor_back"])
def test_mis_weights_consistent_camera(path_spec):
    """With the internally consistent camera-pdf convention
    (bdpt._mis_tables(consistent_camera=True)) the partition of unity is
    tight — the companion check to the reference-parity test above, whose
    5% slack absorbs the reference's convention quirk
    (bidirection.cpp:203-210 vs :246-249)."""
    _check_partition(path_spec, consistent_camera=True, tol=2e-3)


def _check_partition(path_spec, consistent_camera, tol, interior_mat=0,
                     weight_fn=None, check=True):
    """Compute the (s,t) weights of the fixed path with `weight_fn`
    (default bdpt._mis_weight) and, with check=True, assert the
    partition of unity to `tol`.  Returns the weights dict."""
    weight_fn = weight_fn or bdpt._mis_weight
    scene = make_cornell_box()
    cam_pos = np.asarray(scene.camera.pos)
    light_n = np.array([0, -1.0, 0])
    area = 0.48
    nl = 1
    diffuse = interior_mat  # material id at interior path vertices

    # a fixed path: camera -> surfaces -> point on the light
    if path_spec == "floor_back":
        path = [
            (cam_pos, None, -1),
            (np.array([0.2, 0.0, 0.4]), np.array([0.0, 1.0, 0.0]), diffuse),
            (np.array([-0.3, 0.8, -1.0]), np.array([0.0, 0.0, 1.0]), diffuse),
            (np.array([0.1, 1.49, 0.05]), light_n, -1),
        ]
    else:
        path = [
            (cam_pos, None, -1),
            (np.array([-1.0, 0.6, 0.2]), np.array([1.0, 0.0, 0.0]), diffuse),
            (np.array([0.4, 0.0, -0.2]), np.array([0.0, 1.0, 0.0]), diffuse),
            (np.array([0.9, 0.9, -1.0]), np.array([0.0, 0.0, 1.0]), diffuse),
            (np.array([-0.2, 1.49, -0.1]), light_n, -1),
        ]
    k = len(path)
    light_pos = path[-1][0]
    # light v1 fields: area pdf and cosine dir pdf toward the previous vertex
    toward_prev = path[-2][0] - light_pos
    toward_prev = toward_prev / np.linalg.norm(toward_prev)
    o2w_l = make_coord_space(jnp.asarray([light_n], jnp.float32))
    dir_pdf_light = float(samplers.cosine_hemisphere_pdf(
        to_local(o2w_l, jnp.asarray([toward_prev], jnp.float32)))[0])
    p1_light = (1.0 / area) / nl

    # eye v1 direction normal = ray dir toward v2
    eye_dir = path[1][0] - cam_pos
    eye_dir = eye_dir / np.linalg.norm(eye_dir)

    weights = {}
    for s in range(1, k + 1):
        t = k - s
        eye_verts = [(path[0][0], eye_dir, -1)] + \
            [(p, n, m) for (p, n, m) in path[1:s]]
        light_verts = [(light_pos, light_n, -1)] + \
            [(p, n, m) for (p, n, m) in path[s:k - 1][::-1]]
        eye = _subpath(eye_verts, 1.0, 1.0)
        light = _subpath(light_verts, dir_pdf_light, p1_light)

        light_sample = None
        eye_sample = None
        if t == 1:
            light_sample = dict(
                pos=jnp.asarray([light_pos], jnp.float32),
                n=jnp.asarray([light_n], jnp.float32),
                alpha=jnp.ones((1, 3)), p=jnp.asarray([p1_light]),
                mat=jnp.asarray([-1], jnp.int32), valid=jnp.asarray([True]),
                dir_pdf=jnp.asarray([dir_pdf_light], jnp.float32))
        if s == 1:
            ci = camera_ops.sample_ray_pdf(
                scene.camera, jnp.asarray([path[1][0]], jnp.float32), 64, 48)
            eye_sample = dict(
                pos=ci.point, n=ci.normal, alpha=jnp.ones((1, 3)),
                p=ci.point_pdf, mat=jnp.asarray([-1], jnp.int32),
                valid=jnp.asarray([True]), dir_pdf=ci.dir_pdf)

        if t == 0:
            eol = bdpt._eye_on_light_pdfs(
                scene, jnp.asarray([light_pos], jnp.float32),
                jnp.asarray([path[-2][0]], jnp.float32))
            eol3 = (eol[0], eol[1], eol[2])
            assert bool(eol[0][0]), "light endpoint must be on the light"
        else:
            eol3 = (jnp.zeros((1,), bool), jnp.zeros((1,)),
                    lambda _: jnp.zeros((1,)))

        w = weight_fn(scene, s, t, eye, light, light_sample,
                      eye_sample, eol3,
                      consistent_camera=consistent_camera)
        weights[(s, t)] = float(w[0])

    if not check:
        return weights
    total = sum(weights.values())
    assert all(0.0 <= v <= 1.0 + 1e-4 for v in weights.values()), weights
    # The reference's camera-pdf convention is internally inconsistent by a
    # cos(theta_surface)/cos(theta_axis) factor: the current-strategy
    # denominator for the camera vertex is fixed to 1*1
    # (bidirection.cpp:203-210) while alternative strategies use
    # eye_sample.dir_pdf * G (bidirection.cpp:246-249).  We replicate the
    # reference exactly (verified via path replay), so the partition of
    # unity holds only to a few percent near the view axis.
    assert abs(total - 1.0) < tol, (weights, total)
    return weights


@pytest.mark.parametrize("path_spec", ["floor_back", "wall_floor_back"])
@pytest.mark.parametrize("interior_mat", [0, 7, 5])
def test_table_form_matches_walk(path_spec, interior_mat):
    """The r05 table-form _mis_weight (O(1) per combo via suffix-square
    sums) equals the sequential pdf-ratio walk on every (s,t) strategy —
    diffuse interiors, microfacet interiors (id 7), and MIRROR interiors
    (id 5: delta-skip masks and dead-ratio zero propagation, where the
    naive quotient form of the suffix products would produce 0/0)."""
    kw = dict(consistent_camera=True, tol=0.0, check=False,
              interior_mat=interior_mat)
    wt = _check_partition(path_spec, weight_fn=bdpt._mis_weight, **kw)
    ww = _check_partition(path_spec, weight_fn=bdpt._mis_weight_walk, **kw)
    assert wt.keys() == ww.keys()
    for k in wt:
        assert abs(wt[k] - ww[k]) <= 1e-5 + 1e-4 * abs(ww[k]), \
            (k, wt[k], ww[k])


def test_consistent_camera_config_wiring_fast():
    """RenderConfig.bdpt_consistent_camera (VERDICT r04 #5) reaches the
    integrator: the Veach-exact camera-step pricing produces a slightly
    different (same-expectation) image than the reference-parity default
    on the same sample stream."""
    from bidirectional_pathtracing.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing.utils.render import render
    scene = make_cornell_box()
    imgs = {}
    for cc in (False, True):
        cfg = RenderConfig(spp=4, max_ray_depth=3, width=24, height=18,
                           integrator="bdpt", bdpt_consistent_camera=cc)
        imgs[cc] = np.asarray(render(scene, cfg).combined)
    # same paths, different MIS weights: images differ per-pixel; the
    # convention bend is smallest near the view axis (it grows toward
    # frame edges with the camera-step cosine factors), so compare means
    # over the central third (the quantitative full-frame check is
    # test_consistent_camera_golden_level)
    assert not np.array_equal(imgs[False], imgs[True])
    ctr = (slice(6, 12), slice(8, 16))
    rel = abs(imgs[False][ctr].mean() - imgs[True][ctr].mean()) \
        / (imgs[False][ctr].mean() + 1e-9)
    assert rel < 0.06, rel


@pytest.mark.slow
def test_consistent_camera_golden_level():
    """Both camera-MIS conventions converge to the same image on
    CBspheres_lambertian (quantifying the few-percent view-axis effect:
    block-mean relative gap stays small, VERDICT r04 #5)."""
    import os
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils.render import render
    ref = "/root/reference"
    if not os.path.isdir(ref):
        pytest.skip("no reference assets")
    scene, _ = load_scene(f"{ref}/dae/sky/CBspheres_lambertian.dae", 60, 45)
    imgs = {}
    for cc in (False, True):
        cfg = RenderConfig(spp=32, max_ray_depth=5, width=60, height=45,
                           integrator="bdpt", bdpt_consistent_camera=cc)
        imgs[cc] = np.asarray(render(scene, cfg).combined)

    def blocks(img, nb=6):
        bh, bw = img.shape[0] // nb, img.shape[1] // nb
        return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))

    a, b = blocks(imgs[False]), blocks(imgs[True])
    err = np.abs(a - b) / (np.abs(b) + 0.05)
    # identical estimand; weight convention shifts variance a few percent
    assert err.mean() < 0.03, (err.mean(), err.max())
