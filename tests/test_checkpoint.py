import pytest
"""Checkpoint/resume: an interrupted render resumed from disk produces the
same buffers as an uninterrupted one (counter-based sample stream)."""

import numpy as np

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.scene.procedural import make_cornell_box
from bidirectional_pathtracing.utils.render import render

pytestmark = pytest.mark.slow


def test_resume_matches_uninterrupted(tmp_path):
    scene = make_cornell_box()
    cfg = RenderConfig(spp=4, max_ray_depth=2, width=24, height=16,
                       integrator="bdpt")
    full = render(scene, cfg)

    path = str(tmp_path / "state.npz")
    # run with per-pass checkpointing, then simulate a crash after pass 2 by
    # re-rendering from the saved state
    render(scene, cfg, checkpoint_path=path, checkpoint_every=1)
    from bidirectional_pathtracing.utils import checkpoint as ckpt
    fp = ckpt.config_fingerprint(cfg, cfg.width, cfg.height)
    st = ckpt.load_checkpoint(path, fp)
    assert st is not None and st["next_pass"] == cfg.spp - 1

    resumed = render(scene, cfg, checkpoint_path=path)
    np.testing.assert_allclose(resumed.combined, full.combined,
                               rtol=1e-6, atol=1e-7)


def test_checkpoint_rejects_config_change(tmp_path):
    scene = make_cornell_box()
    cfg = RenderConfig(spp=3, max_ray_depth=2, width=24, height=16,
                       integrator="bdpt")
    path = str(tmp_path / "state.npz")
    render(scene, cfg, checkpoint_path=path, checkpoint_every=1)
    from bidirectional_pathtracing.utils import checkpoint as ckpt
    other = RenderConfig(spp=3, max_ray_depth=3, width=24, height=16,
                         integrator="bdpt")
    fp = ckpt.config_fingerprint(other, 24, 16)
    assert ckpt.load_checkpoint(path, fp) is None
