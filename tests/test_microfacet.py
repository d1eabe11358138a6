"""Microfacet (Beckmann + conductor Fresnel) vs reference-oracle golden.

Also checks BDPT runs with microfacet materials — the reference crashes
there (MicrofacetBSDF::sample_pdf assert(0), advanced_bsdf.cpp:144-148);
we implement the proper NDF pdf instead (documented upgrade).
"""

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")]


@pytest.fixture(scope="module")
def mf_scene():
    from bidirectional_pathtracing.scene.build import load_scene
    scene, aux = load_scene(
        f"{REFERENCE}/dae/sky/CBspheres_microfacet_al_ag.dae", 120, 90)
    kinds = [r["kind"] for r in aux["material_records"]]
    assert kinds.count(5) == 2  # two microfacet materials
    return scene


def _blocks(img, nb=6):
    h, w = img.shape[:2]
    bh, bw = h // nb, w // nb
    return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))


def test_microfacet_pt_golden(mf_scene):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=16, max_ray_depth=5, width=120, height=90,
                       integrator="pt", light_samples=4)
    res = render(mf_scene, cfg)
    ref = np.load(
        "tests/golden/cbspheres_microfacet_pt_120x90_32spp_d5_l4.npz")
    a, b = _blocks(ref["combined"]), _blocks(res.combined)
    err = np.abs(a - b) / (np.abs(a) + 0.05)
    # microfacet highlights are noisy at 16 vs 32 spp; at 48 spp the error
    # drops to 1.9%/5.7% (verified), so these bounds are MC headroom
    assert err.mean() < 0.045, err.mean()
    assert err.max() < 0.2, err.max()


def test_microfacet_bdpt_runs(mf_scene):
    """BDPT with microfacet: finite output, nonzero image (the reference
    cannot do this at all)."""
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=2, max_ray_depth=4, width=60, height=45,
                       integrator="bdpt")
    res = render(mf_scene, cfg)
    assert np.isfinite(res.combined).all()
    assert res.combined.mean() > 0.05


def test_microfacet_bdpt_matches_pt(mf_scene):
    """BDPT == PT block convergence on the microfacet scene: both
    estimators are unbiased, so their converged renders must agree.  This
    is the oracle-free validation of microfacet under BDPT MIS (priced
    with the true NDF pdf via the real arrival direction, ops/bsdf.py
    mis_pdf; adjoint Fresnel on light walks).

    The PT side MUST run with pt_reference_nee=False: the reference's
    area-light NEE carries a 1/d^3 falloff quirk (light.cpp:210-215 pdf
    uses an unnormalised direction + pathtracer.cpp:143 divides by d^2)
    that makes its PT ~20% DARK on Cornell-box scenes — measured r04:
    the reference's own oracle goldens disagree, BDPT/PT combined-mean
    ratio 1.226 on CBspheres_lambertian and 1.195 on CBspheres (pure
    diffuse / delta scenes, no microfacet anywhere).  Against the
    physically-correct NEE, BDPT/PT = 1.008 (lambertian) and 1.009
    (microfacet) at matched depth.  The r03 red version of this test
    compared against the quirked PT and mis-attributed that gap to
    microfacet MIS.

    The referee is the MIS PT mode (pt_mis: NEE + BSDF-sampled emission
    pickup under the power heuristic): plain-NEE PT is hopelessly
    heavy-tailed on the near-specular conductor limbs (a camera ray
    grazing the Al sphere sees the light's reflection; NEE hits the
    near-delta lobe rarely but with huge f, measured per-pixel estimates
    spanning 1e-12..18.5 where the converged value is ~9), so its renders
    cannot referee those blocks at test-size spp.  The BDPT side relies
    on the r04 t=1 junction fix (models/bdpt.py _mis_weight t1_reference
    docstring): with the reference's defective pricing, lobe-aligned
    fresh light samples escape MIS damping (w~0.96 where ~5e-4 is
    correct) and the limb blocks read ~2x bright with 500x fireflies."""
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    w, h, depth = 96, 72, 5
    b = render(mf_scene, RenderConfig(
        spp=48, max_ray_depth=depth, width=w, height=h,
        integrator="bdpt")).combined
    p = render(mf_scene, RenderConfig(
        spp=48, max_ray_depth=depth, width=w, height=h,
        integrator="pt", light_samples=2, pt_reference_nee=False,
        pt_mis=True)).combined
    a, c = _blocks(b), _blocks(p)
    err = np.abs(a - c) / (np.abs(c) + 0.05)
    assert err.mean() < 0.05, (err.mean(), err.max())
    assert err.max() < 0.25, err.max()


def test_bdpt_matches_correct_pt_lambertian():
    """The control experiment for the test above, on a scene with NO
    microfacet at all: BDPT vs quirk-free PT on CBspheres_lambertian.
    Isolates the reference NEE quirk from any microfacet question — if
    this fails the same way the microfacet comparison fails, the cause is
    integrator-level, not the BSDF."""
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils.render import render
    scene, _ = load_scene(
        f"{REFERENCE}/dae/sky/CBspheres_lambertian.dae", 96, 72)
    b = render(scene, RenderConfig(
        spp=48, max_ray_depth=5, width=96, height=72,
        integrator="bdpt")).combined
    p = render(scene, RenderConfig(
        spp=48, max_ray_depth=5, width=96, height=72,
        integrator="pt", light_samples=2, pt_reference_nee=False)).combined
    a, c = _blocks(b), _blocks(p)
    err = np.abs(a - c) / (np.abs(c) + 0.05)
    assert err.mean() < 0.05, (err.mean(), err.max())
    assert err.max() < 0.25, err.max()
