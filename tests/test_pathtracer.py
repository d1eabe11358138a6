"""Unidirectional path tracer vs reference-oracle golden renders.

Goldens in tests/golden/ were produced by compiling the reference's own
integrator sources into a headless harness and rendering the dumped scenes
(same camera/FOV pipeline).  Comparison is block-averaged to suppress Monte
Carlo noise; both renderers are unbiased for the same estimator so block
means converge to the same values.
"""

import numpy as np
import pytest

from tests.conftest import reference_available

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")]

GOLDEN = "tests/golden"


def _block_err(a, b, nb=8, floor=0.05):
    h, w = a.shape[:2]
    bh, bw = h // nb, w // nb
    ab = a[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))
    bb = b[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))
    return np.abs(ab - bb) / (np.abs(ab) + floor)


def test_pt_matches_reference_cbspheres_lambertian(cbspheres_lambertian):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    scene, _ = cbspheres_lambertian
    cfg = RenderConfig(spp=32, max_ray_depth=5, width=120, height=90,
                       integrator="pt", light_samples=4)
    res = render(scene, cfg)
    ref = np.load(f"{GOLDEN}/cbspheres_lambertian_pt_120x90_64spp_d5_l4.npz")
    err = _block_err(ref["combined"], res.combined)
    assert err.mean() < 0.02, err.mean()
    assert err.max() < 0.08, err.max()


def test_pt_deterministic(cbspheres_lambertian):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    scene, _ = cbspheres_lambertian
    cfg = RenderConfig(spp=2, max_ray_depth=3, width=40, height=30,
                       integrator="pt", light_samples=1)
    a = render(scene, cfg)
    b = render(scene, cfg)
    np.testing.assert_array_equal(a.combined, b.combined)
