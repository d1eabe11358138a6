"""Multi-device SPMD tests on the virtual 8-CPU-device mesh.

Assert bitwise equality of renders across mesh shapes — possible because
of the counter-based per-(pixel, sample) RNG (SURVEY.md section 4
implication (d))."""

import jax
import numpy as np
import pytest

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.parallel.render import (
    make_render_mesh, render_frame_sharded)
from bidirectional_pathtracing.scene.procedural import make_cornell_box

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def box():
    return make_cornell_box()


def _cfg(integrator):
    return RenderConfig(spp=2, max_ray_depth=3, width=40, height=24,
                        integrator=integrator)


@pytest.mark.parametrize("integrator", ["bdpt", "pt"])
def test_mesh_shape_invariance(box, integrator):
    """Counter-based RNG: the sampled paths are identical for any mesh
    shape.  Pixel values agree to ~1 ULP (XLA may reassociate/fma
    differently per shard shape; the scatter-add summation order also
    varies) — a genuinely different sample set would differ at the 1e-1
    noise level across most pixels, so the tight tolerance on 99.8% of
    elements pins the RNG invariance.  A RARE knife-edge discrete flip is
    admitted (<=0.2% of elements, each <1e-3): a ~1-ULP compile-variant
    rounding under a branch (strategy gate, closest-hit tie, splat pixel
    cast) flips one sample's discrete decision; measured instance: one
    pixel at 5e-4 on the dp4xsp2 mesh (r03)."""
    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    cfg = _cfg(integrator)
    results = []
    for devs, sp in ((1, 1), (4, 1), (8, 1), (8, 2)):
        mesh = make_render_mesh(jax.devices()[:devs], sp=sp)
        results.append(render_frame_sharded(box, cfg, mesh))
    base_eye, base_light, base = results[0]
    assert np.isfinite(base).all()
    assert base.mean() > 0.01  # the box renders something

    def check(a, b, atol):
        d = np.abs(a - b)
        bad = d > atol
        assert bad.mean() <= 0.002, (bad.sum(), float(d.max()))
        assert d.max() < 1e-3, float(d.max())

    for eye, light, combined in results[1:]:
        check(base_eye, eye, 1e-6)
        check(base_light, light, 1e-5)


def test_sp_axis_partitions_samples(box):
    """spp split over sp must average the same sample set."""
    cfg = RenderConfig(spp=4, max_ray_depth=2, width=16, height=12,
                       integrator="bdpt")
    mesh1 = make_render_mesh(jax.devices()[:1], sp=1)
    mesh4 = make_render_mesh(jax.devices()[:4], sp=4)
    eye_a, light_a, _ = render_frame_sharded(box, cfg, mesh1)
    eye_b, light_b, _ = render_frame_sharded(box, cfg, mesh4)
    # psum tree reduction over 4 sample rows vs sequential scan: identical
    # sample set, fp-order tolerance
    np.testing.assert_allclose(eye_a, eye_b, atol=1e-5)
    np.testing.assert_allclose(light_a, light_b, atol=1e-5)
