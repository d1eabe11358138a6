"""BVH visualizer: navigation semantics + image composition
(the headless equivalent of RaytracedRenderer::visualize_accel,
raytraced_renderer.cpp:376-467)."""

import numpy as np
import pytest

from bidirectional_pathtracing.scene.bvh import build_bvh
from bidirectional_pathtracing.scene.procedural import make_cornell_box
from bidirectional_pathtracing.utils.bvh_vis import (
    BVHVisualizer, collect_ray_log, save_visualization)


@pytest.fixture(scope="module")
def vis():
    box = make_cornell_box()
    box = box._replace(bvh=build_bvh(box.geometry))
    return BVHVisualizer(box)


def test_navigation_stack(vis):
    vis.stack = [0]
    assert vis.current() == 0
    assert not vis.is_leaf()
    l, r = vis.children(0)
    vis.to_left()
    assert vis.current() == l
    vis.up()
    vis.to_right()
    assert vis.current() == r
    vis.up()
    assert vis.current() == 0
    vis.up()  # popping the root is a no-op (reference keeps >=1 entry)
    assert vis.current() == 0
    vis.navigate("lu")
    assert vis.current() == 0


def test_subtree_prims_partition(vis):
    """Left + right subtree prims partition the parent's prims."""
    vis.stack = [0]
    root_prims = set(vis.subtree_prims(0).tolist())
    n_geom = (vis.scene.geometry.num_tris
              + int(np.asarray(vis.scene.geometry.sph_valid).sum())
              - int((~np.asarray(vis.scene.geometry.tri_valid)).sum()))
    assert len(root_prims) == n_geom
    l, r = vis.children(0)
    lp = set(vis.subtree_prims(l).tolist())
    rp = set(vis.subtree_prims(r).tolist())
    assert lp | rp == root_prims
    assert not (lp & rp)


def test_render_image_and_rays(vis, tmp_path):
    vis.stack = [0]
    w, h = 64, 48
    img = vis.render(w, h)
    assert img.shape == (h, w, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05, "nothing drawn"
    # selected-subtree primitives use the blue-tinted fill colors
    # (raytraced_renderer.cpp:388-389): blue channel dominates somewhere
    assert (img[..., 2] > img[..., 0] + 0.05).any()

    log = collect_ray_log(vis.scene, w, h, stride=97)
    img2 = vis.render(w, h, ray_log=log, ray_stride=1)
    assert not np.allclose(img, img2), "ray overlay changed nothing"

    path = str(tmp_path / "vis_bvh.png")
    save_visualization(path, img2)
    from bidirectional_pathtracing.utils.png import read_png
    out = read_png(path)
    assert out.shape[:2] == (h, w)


def test_render_leaf_selection(vis):
    vis.stack = [0]
    while not vis.is_leaf():
        vis.to_left()
    img = vis.render(48, 32)
    assert np.isfinite(img).all()
    vis.stack = [0]
