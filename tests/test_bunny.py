"""Large-mesh end-to-end: CBbunny (28.5k triangles) through the BVH path,
validated against reference-oracle goldens."""

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")]


def _blocks(img, nb=6):
    h, w = img.shape[:2]
    bh, bw = h // nb, w // nb
    return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).mean((1, 3))


@pytest.fixture(scope="module")
def bunny():
    from bidirectional_pathtracing.scene.build import load_scene
    scene, aux = load_scene(f"{REFERENCE}/dae/sky/CBbunny.dae", 120, 90)
    assert scene.bvh is not None, "BVH should auto-attach for 28k tris"
    return scene


def test_bunny_pt_golden(bunny):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.utils.render import render
    cfg = RenderConfig(spp=8, max_ray_depth=5, width=120, height=90,
                       integrator="pt", light_samples=4)
    res = render(bunny, cfg)
    ref = np.load("tests/golden/cbbunny_pt_120x90_16spp_d5_l4.npz")
    a, b = _blocks(ref["combined"]), _blocks(res.combined)
    err = np.abs(a - b) / (np.abs(a) + 0.05)
    assert err.mean() < 0.03, err.mean()
    assert err.max() < 0.12, err.max()
