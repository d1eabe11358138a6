"""BDPT vs reference-oracle golden renders (block-averaged comparison)."""

import numpy as np
import pytest

from tests.conftest import reference_available

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")]

GOLDEN = "tests/golden"


def _blocks(img, nb=8):
    h, w = img.shape[:2]
    bh, bw = h // nb, w // nb
    return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))


def _block_err(ref, mine, floor=0.05):
    a, b = _blocks(ref), _blocks(mine)
    return np.abs(a - b) / (np.abs(a) + floor)


def _render(scene, spp):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=spp, max_ray_depth=5, width=120, height=90,
                       integrator="bdpt")
    return render(scene, cfg)


def test_bdpt_matches_reference_cbspheres_lambertian(cbspheres_lambertian):
    scene, _ = cbspheres_lambertian
    res = _render(scene, 16)
    ref = np.load(f"{GOLDEN}/cbspheres_lambertian_bdpt_120x90_64spp_d5.npz")
    err_eye = _block_err(ref["eye"], res.eye)
    assert err_eye.mean() < 0.02, err_eye.mean()
    assert err_eye.max() < 0.10, err_eye.max()
    # light image is sparse/heavy-tailed; compare the overall mean
    assert abs(res.light.mean() - ref["light"].mean()) \
        < 0.25 * ref["light"].mean() + 1e-4


def test_bdpt_matches_reference_cbspheres_delta_bsdfs(cbspheres):
    """Mirror + glass spheres: exercises delta-BSDF subpaths and the MIS
    delta rules (BASELINE config #2)."""
    scene, _ = cbspheres
    res = _render(scene, 16)
    ref = np.load(f"{GOLDEN}/cbspheres_bdpt_120x90_64spp_d5.npz")
    err_eye = _block_err(ref["eye"], res.eye, floor=0.1)
    assert err_eye.mean() < 0.035, err_eye.mean()
    assert err_eye.max() < 0.25, err_eye.max()
    assert abs(res.light.mean() - ref["light"].mean()) \
        < 0.3 * ref["light"].mean() + 1e-4
