"""Interactive viewer: reference key semantics (application.cpp:424-529,
raytraced_renderer.cpp:510-589), progressive accumulation, HTTP front-end."""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.scene.procedural import make_cornell_box
from bidirectional_pathtracing.viewer import (
    RENDER_MODE, VISUALIZE_MODE, Viewer, _make_server)


def make_viewer(**kw):
    cfg = RenderConfig(spp=4, max_ray_depth=2, width=16, height=12,
                       integrator=kw.pop("integrator", "bdpt"), **kw)
    return Viewer(make_cornell_box(), cfg, output="/tmp/viewer_test.png")


def test_param_keys_match_reference_semantics():
    v = make_viewer()
    v.key_press("]")
    assert v.cfg.spp == 8
    v.key_press("[")
    v.key_press("[")
    v.key_press("[")
    v.key_press("[")
    assert v.cfg.spp == 1, "spp floor is 1 (raytraced_renderer.cpp:521)"
    v.key_press("=")
    assert v.cfg.light_samples == 2
    v.key_press("-")
    v.key_press("-")
    assert v.cfg.light_samples == 1
    v.key_press(".")
    assert v.cfg.max_ray_depth == 3
    v.key_press(",")
    v.key_press(",")
    v.key_press(",")
    v.key_press(",")
    assert v.cfg.max_ray_depth == 0, "depth floor is 0"
    h0 = v.cfg.direct_hemisphere_sample
    v.key_press("h")
    assert v.cfg.direct_hemisphere_sample != h0
    v.key_press("l")
    assert abs(float(v.scene.camera.lens_radius) - 0.05) < 1e-6
    v.key_press("k")
    v.key_press("k")
    assert float(v.scene.camera.lens_radius) == 0.0, "lens radius floor 0"
    fd0 = float(v.scene.camera.focal_distance)
    v.key_press("'")
    assert abs(float(v.scene.camera.focal_distance) - fd0 - 0.1) < 1e-5


def test_mode_switch_and_quit():
    v = make_viewer()
    assert v.mode == RENDER_MODE
    v.key_press("v")
    assert v.mode == VISUALIZE_MODE
    # arrows walk the BVH selection
    vis = v._visualizer()
    assert vis.current() == 0
    v.key_press("LEFT")
    assert vis.current() != 0
    v.key_press("UP")
    assert vis.current() == 0
    v.key_press("a")
    assert v.show_rays
    v.key_press("r")
    assert v.mode == RENDER_MODE
    assert v.key_press("q") is False
    assert v._quit


@pytest.mark.slow
def test_progressive_mean_matches_batch_render():
    from bidirectional_pathtracing.utils.render import render
    v = make_viewer()
    for _ in range(4):
        assert v.tick()
    assert not v.tick(), "stops at cfg.spp passes"
    batch = render(make_cornell_box(),
                   RenderConfig(spp=4, max_ray_depth=2, width=16, height=12,
                                integrator="bdpt"))
    np.testing.assert_allclose(v.frame(), batch.combined,
                               rtol=1e-5, atol=1e-6)


def test_param_key_restarts_accumulation():
    v = make_viewer()
    v.tick()
    assert v.passes == 1
    v.key_press("]")
    assert v.passes == 0, "parameter keys restart the render"


def test_visualize_frame_is_image():
    v = make_viewer()
    v.key_press("v")
    f = v.frame()
    assert f.shape == (12, 16, 3)
    assert np.isfinite(f).all()
    assert f.max() > 0.0


def test_http_endpoints():
    v = make_viewer()
    v.tick()
    server = _make_server(v, 0)  # port 0 = ephemeral
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, r.read()

        st, body = get("/")
        assert st == 200 and b"bdpt viewer" in body
        st, body = get("/frame.png")
        assert st == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        st, body = get("/status")
        assert st == 200 and b"RENDER" in body
        spp0 = v.cfg.spp
        st, _ = get("/key?k=%5D")  # ']'
        assert st == 200
        assert v.cfg.spp == spp0 * 2
        with pytest.raises(urllib.error.HTTPError) as exc:
            get("/nope")
        assert exc.value.code == 404
    finally:
        server.shutdown()


def test_edit_mode_applies_mesh_ops_and_dump_key():
    from bidirectional_pathtracing.viewer import EDIT_MODE
    calls = []

    def reload_fn(ops):
        calls.append(tuple(ops))
        return make_cornell_box()

    cfg = RenderConfig(spp=2, max_ray_depth=2, width=16, height=12,
                       integrator="bdpt")
    v = Viewer(make_cornell_box(), cfg, output="/tmp/viewer_test.png",
               scene_name="/tmp/viewer_edit_test", reload_fn=reload_fn)
    v.key_press("e")
    assert v.mode == EDIT_MODE
    v.key_press("u")
    v.key_press("i")
    assert calls == [("upsample",), ("upsample", "resample")]
    v.key_press("x")
    assert calls[-1] == ()
    v.key_press("r")
    assert v.mode == RENDER_MODE
    # 'd' camera dump writes the real reference format (regression: the
    # viewer once called dump_camera_settings with the wrong arity)
    v.key_press("d")
    from bidirectional_pathtracing.scene.camera_file import (
        load_camera_settings)
    cam = load_camera_settings("/tmp/viewer_edit_test_cam_settings.txt")
    np.testing.assert_allclose(np.asarray(cam.pos),
                               np.asarray(v.scene.camera.pos), rtol=1e-5)


def test_edit_mode_requires_reload_fn():
    v = make_viewer()
    v.key_press("e")
    assert v.mode == RENDER_MODE  # refused, with a message
    assert any("reload_fn" in m for m in v.messages)


def test_debugger_commands_edit_materials_and_lights():
    """Headless form of the reference's ImGui VisualDebugger parameter
    editors (visual_debugger.cpp; DragDouble used in bsdf.cpp:87-94)."""
    v = make_viewer()
    v.key_press("tree")
    assert any("mat 0:" in m for m in v.messages)
    assert any("light 0:" in m for m in v.messages)
    v.tick()
    assert v.passes == 1
    v.key_press("mat 0 albedo 0.9 0.1 0.1")
    assert v.passes == 0  # render restarted
    np.testing.assert_allclose(
        np.asarray(v.scene.materials.albedo[0]), [0.9, 0.1, 0.1])
    v.key_press("light 0 radiance 5 5 5")
    np.testing.assert_allclose(
        np.asarray(v.scene.lights.radiance[0]), [5, 5, 5])
    v.key_press("mat 0 ior 1.33")
    assert abs(float(v.scene.materials.ior[0]) - 1.33) < 1e-6
    v.key_press("mat 99 albedo nonsense")
    assert any("bad command" in m for m in v.messages)
