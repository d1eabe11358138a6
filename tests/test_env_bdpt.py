"""Environment-light BDPT support (EXTENSION beyond the reference, whose
BDPT asserts on env lights, environment_light.cpp:182-208).

Strategy families (models/bdpt.py env section): primary-miss radiance,
env NEE per non-delta vertex, and — on pure-env scenes — ENV LIGHT
SUBPATHS (envlight.sample_Le emission walks splatted to the camera),
power-2 MIS-weighted against the NEE strategy of each path class.  The
partition is complete, so the converged BDPT render must still agree
with the PT integrator's."""

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available


def test_bdpt_env_smoke_fast():
    """Fast-tier coverage: the env-BDPT code path compiles, produces
    finite nonzero radiance on an env-only scene, and stays zero-impact
    when envmap is None."""
    scene = _scene_with_env()
    img = _render(scene, "bdpt", 2, w=20, h=15)
    assert np.isfinite(img).all() and img.mean() > 0.01
    dark = _render(scene._replace(envmap=None), "bdpt", 2, w=20, h=15)
    assert dark.max() == 0.0   # no lights at all -> black


def test_bdpt_env_subpath_splats_fast():
    """Env light subpaths produce finite, nonnegative light-image splats
    on a pure-env scene (the (c) strategy family)."""
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    scene = _scene_with_env()
    res = render(scene, RenderConfig(spp=8, max_ray_depth=4, width=40,
                                     height=30, integrator="bdpt"))
    assert np.isfinite(res.light).all()
    assert (res.light >= 0).all()
    assert res.light.sum() > 0.0



def test_bdpt_env_mixed_smoke_fast():
    """MIXED env+area scene (VERDICT r04 #3): the env subpath family runs
    alongside the area-light (s,t) families — finite output, env splats
    land in the light image."""
    import numpy as np
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    scene = _mixed_scene()
    res = render(scene, RenderConfig(spp=4, max_ray_depth=4, width=40,
                                     height=30, integrator="bdpt"))
    assert np.isfinite(res.combined).all()
    assert res.combined.mean() > 0.01
    assert res.light.sum() > 0.0


def _scene_with_env():
    from examples.inverse_rendering import _env_image, _open_scene
    from bidirectional_pathtracing.ops import envlight
    scene = _open_scene()
    return scene._replace(envmap=envlight.build_envmap(_env_image()))


def _mixed_scene():
    """The procedural Cornell box (area light + diffuse spheres, the
    CBspheres_lambertian layout) with an envmap attached — the reference's
    normal `-e` path appends the env light to scene->lights
    (raytraced_renderer.cpp:117-119)."""
    from examples.inverse_rendering import _env_image
    from bidirectional_pathtracing.ops import envlight
    from bidirectional_pathtracing.scene.procedural import make_cornell_box
    scene = make_cornell_box(sphere_materials=("diffuse", "diffuse"))
    return scene._replace(envmap=envlight.build_envmap(_env_image()))


def _render(scene, integrator, spp, w=60, h=45):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=spp, max_ray_depth=4, width=w, height=h,
                       integrator=integrator, light_samples=1)
    return render(scene, cfg).combined


def _blocks(img, nb=6):
    bh, bw = img.shape[0] // nb, img.shape[1] // nb
    return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))


@pytest.mark.slow
def test_bdpt_env_matches_pt():
    scene = _scene_with_env()
    bdpt_img = _render(scene, "bdpt", 48)
    pt_img = _render(scene, "pt", 48)
    a, b = _blocks(bdpt_img), _blocks(pt_img)
    err = np.abs(a - b) / (np.abs(b) + 0.05)
    assert err.mean() < 0.05, (err.mean(), err.max())
    assert err.max() < 0.25, err.max()
    # the env actually contributes (scene has no analytic lights)
    assert bdpt_img.mean() > 0.05


@pytest.mark.slow
def test_bdpt_env_mixed_matches_pt():
    """Partition check on a MIXED env+area scene: env-emission paths and
    area-light paths are disjoint path-space supports, each with its own
    complete MIS partition ((b)/(c) for env classes, the (s,t) families
    for area classes), so converged BDPT must equal converged PT.
    pt_reference_nee=False: the reference PT's 1/d^3 NEE quirk is ~20%
    dark on Cornell scenes (README, known reference quirks) and would fail
    any cross-integrator comparison."""
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    scene = _mixed_scene()
    imgs = {}
    for integ in ("bdpt", "pt"):
        cfg = RenderConfig(spp=48, max_ray_depth=4, width=60, height=45,
                           integrator=integ, pt_reference_nee=False)
        imgs[integ] = render(scene, cfg).combined
    a, b = _blocks(imgs["bdpt"]), _blocks(imgs["pt"])
    err = np.abs(a - b) / (np.abs(b) + 0.05)
    assert err.mean() < 0.05, (err.mean(), err.max())
    assert err.max() < 0.25, err.max()
    # both light families actually contribute: darker than env-only+area
    # sum would be if either were dropped — sanity: image is lit
    assert imgs["bdpt"].mean() > 0.05


@pytest.mark.slow
@pytest.mark.skipif(not reference_available(), reason="no reference")
def test_bdpt_env_mixed_specular_matches_pt():
    """Mixed env+area with DELTA BSDFs in view (mirror + glass spheres):
    exercises the full three-way env MIS — (b) NEE with the camera-vertex
    delta-skip (ADVICE r04 #1), (c) subpath splats, (d) walk-miss pickup
    through specular chains — on top of the mixed-scene gate.  Referee is
    the pt_mis PT: the reference-parity PT terminates secondary misses
    black and cannot see env through speculars (BENCH_NOTES r05)."""
    from examples.inverse_rendering import _env_image
    from bidirectional_pathtracing.ops import envlight
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    scene, _ = load_scene(f"{REFERENCE}/dae/sky/CBspheres.dae", 60, 45)
    scene = scene._replace(envmap=envlight.build_envmap(_env_image()))
    imgs = {}
    for integ, ptmis in (("bdpt", False), ("pt", True)):
        cfg = RenderConfig(spp=64, max_ray_depth=5, width=60, height=45,
                           integrator=integ, pt_reference_nee=False,
                           pt_mis=ptmis)
        imgs[integ] = render(scene, cfg).combined
    a, b = _blocks(imgs["bdpt"]), _blocks(imgs["pt"])
    err = np.abs(a - b) / (np.abs(b) + 0.05)
    assert err.mean() < 0.06, (err.mean(), err.max())


@pytest.mark.slow
def test_bdpt_env_specular_chains_match_mis_pt():
    """Pure-env scene with ONLY delta spheres (mirror+mirror): the env
    seen via specular chains is sampled exclusively by strategy (d)
    (walk-miss pickup) on the BDPT side and the pt_mis bounce-miss pickup
    on the PT side; converged images must agree.  (Without (d) this
    measured an 8.8% systematic gap — BENCH_NOTES r05.)"""
    import jax.numpy as jnp
    from examples.inverse_rendering import _env_image
    from bidirectional_pathtracing.ops import envlight
    from bidirectional_pathtracing.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing.scene.types import make_lights
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    scene = make_cornell_box(sphere_materials=("mirror", "glass"))
    mats = scene.materials._replace(
        emission=jnp.zeros_like(scene.materials.emission))
    scene = scene._replace(lights=make_lights([]), materials=mats,
                           envmap=envlight.build_envmap(_env_image()))
    imgs = {}
    for integ, ptmis in (("bdpt", False), ("pt", True)):
        per_seed = []
        for seed in range(2):
            cfg = RenderConfig(spp=48, max_ray_depth=5, width=60, height=45,
                               integrator=integ, pt_reference_nee=False,
                               pt_mis=ptmis, seed=seed)
            per_seed.append(np.asarray(render(scene, cfg).combined))
        imgs[integ] = np.stack(per_seed).mean(0)
    a, b = _blocks(imgs["bdpt"]), _blocks(imgs["pt"])
    err = np.abs(a - b) / (np.abs(b) + 0.05)
    assert err.mean() < 0.05, (err.mean(), err.max())
    # the specular-env classes actually light the scene (mirror shows sky)
    assert imgs["bdpt"].mean() > 0.1


@pytest.mark.slow
@pytest.mark.skipif(not reference_available(), reason="no reference")
def test_bdpt_env_with_area_light_still_matches_golden():
    """An env-free scene with the BDPT env code path compiled in must be
    untouched (regression: bunny_unlit golden is PT-only; here we check
    CBspheres_lambertian BDPT against its golden with envmap=None)."""
    from bidirectional_pathtracing.scene.build import load_scene
    scene, _ = load_scene(
        f"{REFERENCE}/dae/sky/CBspheres_lambertian.dae", 120, 90)
    img = _render(scene, "bdpt", 16, w=120, h=90)
    ref = np.load(
        "tests/golden/cbspheres_lambertian_bdpt_120x90_64spp_d5.npz")
    # combined comparison at matching depth (golden is d5; use d5 here)
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=16, max_ray_depth=5, width=120, height=90,
                       integrator="bdpt")
    img = render(scene, cfg).combined
    a, b = _blocks(img, 8), _blocks(ref["combined"], 8)
    err = np.abs(a - b) / (np.abs(b) + 0.05)
    assert err.mean() < 0.03, err.mean()
