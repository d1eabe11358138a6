"""Refraction-only BSDF vs reference-oracle goldens (VERDICT r03 #5).

CBspheres_refract.dae is the one delta-BSDF variant with no golden until
round 4: both spheres are pure RefractionBSDF (Snell delta with the
1/eta^2 radiance scaling and TIR blackout, advanced_bsdf.cpp:163-194),
a path the glass BSDF never takes on its own.  PT and BDPT goldens were
produced by the instrumented oracle (tools/oracle/regenerate.py).
"""

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")]

GOLDEN = "tests/golden"


@pytest.fixture(scope="module")
def refract_scene():
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.scene.types import MAT_REFRACTION
    scene, aux = load_scene(
        f"{REFERENCE}/dae/sky/CBspheres_refract.dae", 120, 90)
    kinds = np.asarray(scene.materials.kind)
    assert (kinds == MAT_REFRACTION).sum() >= 1
    return scene


def _blocks(img, nb=8):
    h, w = img.shape[:2]
    bh, bw = h // nb, w // nb
    return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))


def _block_err(ref, mine, floor=0.05):
    a, b = _blocks(ref), _blocks(mine)
    return np.abs(a - b) / (np.abs(a) + floor)


def test_refract_pt_golden(refract_scene):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=16, max_ray_depth=5, width=120, height=90,
                       integrator="pt", light_samples=4)
    res = render(refract_scene, cfg)
    ref = np.load(f"{GOLDEN}/cbspheres_refract_pt_120x90_32spp_d5_l4.npz")
    err = _block_err(ref["combined"], res.combined, floor=0.1)
    assert err.mean() < 0.035, err.mean()
    assert err.max() < 0.25, err.max()


def test_refract_bdpt_golden(refract_scene):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=16, max_ray_depth=5, width=120, height=90,
                       integrator="bdpt")
    res = render(refract_scene, cfg)
    ref = np.load(f"{GOLDEN}/cbspheres_refract_bdpt_120x90_32spp_d5.npz")
    err = _block_err(ref["eye"], res.eye, floor=0.1)
    assert err.mean() < 0.035, err.mean()
    assert err.max() < 0.25, err.max()
    assert abs(res.light.mean() - np.asarray(ref["light"]).mean()) \
        < 0.3 * np.asarray(ref["light"]).mean() + 1e-4
