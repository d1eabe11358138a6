"""Render-driver features: adaptive sampling (95% CI rule) and cell mode."""

import numpy as np

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.scene.procedural import make_cornell_box
from bidirectional_pathtracing.utils.render import render
import pytest


def test_adaptive_sampling_stops_converged_pixels():
    box = make_cornell_box()
    cfg = RenderConfig(spp=24, max_ray_depth=2, width=32, height=24,
                       integrator="pt", adaptive_sampling=True,
                       samples_per_batch=4, max_tolerance=0.3)
    res = render(box, cfg)
    counts = res.sample_counts
    # easy (directly lit, low variance) pixels stop early; some pixels run
    # longer — and nothing exceeds spp
    assert counts.min() >= 4
    assert counts.max() <= 24
    assert counts.min() < counts.max(), "no pixel converged early"
    # the converged image is still sane
    assert np.isfinite(res.combined).all()
    assert res.combined.mean() > 0.01


@pytest.mark.slow
def test_adaptive_matches_uniform_when_tolerance_zero():
    box = make_cornell_box()
    base = RenderConfig(spp=6, max_ray_depth=2, width=16, height=12,
                        integrator="pt")
    adap = RenderConfig(spp=6, max_ray_depth=2, width=16, height=12,
                        integrator="pt", adaptive_sampling=True,
                        samples_per_batch=2, max_tolerance=0.0)
    a = render(box, base)
    b = render(box, adap)
    # zero-variance pixels may legitimately stop early (ci == 0 satisfies
    # ci <= 0*mu, exactly like the reference's rule) but their mean is
    # already exact, so images agree wherever both took all samples
    full = b.sample_counts == 6
    np.testing.assert_allclose(a.combined[full], b.combined[full],
                               rtol=1e-6, atol=1e-7)
    assert full.mean() > 0.9


@pytest.mark.slow
def test_cell_mode_renders_only_rect():
    box = make_cornell_box()
    for integ in ("pt", "bdpt"):
        cfg = RenderConfig(spp=2, max_ray_depth=2, width=32, height=24,
                           integrator=integ, cell=(8, 6, 8, 6))
        res = render(box, cfg)
        mask = np.zeros((24, 32), bool)
        mask[6:12, 8:16] = True
        img = res.eye if integ == "bdpt" else res.combined
        assert img[mask].mean() > 0.01
        assert img[~mask].max() == 0.0


def test_cooperative_cancel_keeps_partial_accumulation():
    """render(cancel=...) stops between passes and renormalizes the
    accumulated samples (the reference's continueRaytracing stop,
    raytraced_renderer.cpp:226,611)."""
    import jax
    import numpy as np
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing.utils.render import render

    class CancelAfter:
        def __init__(self, n):
            self.n = n
            self.calls = 0

        def is_set(self):
            self.calls += 1
            return self.calls >= self.n

    scene = make_cornell_box()
    # samples_per_chunk=1: cancel is checked between dispatches, so the
    # stop granularity is the chunk; one pass per chunk pins the
    # finest-grained behavior
    cfg = RenderConfig(spp=6, max_ray_depth=2, width=16, height=12,
                       integrator="bdpt", samples_per_chunk=1)
    full = render(scene, cfg)
    partial = render(scene, cfg, cancel=CancelAfter(2))
    assert partial.sample_counts.max() == 2
    assert full.sample_counts.max() == 6
    # renormalized partial mean should be near the full mean (same stream,
    # fewer samples)
    assert abs(partial.combined.mean() - full.combined.mean()) \
        < 0.5 * full.combined.mean() + 1e-6
    # the first 2 passes of the full render ARE the partial render's
    # stream: medians agree closely
    assert np.isfinite(partial.combined).all()
