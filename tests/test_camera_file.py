"""Camera settings file round-trip (reference camera.cpp:152-186 format)."""

import numpy as np

from bidirectional_pathtracing.scene.camera_file import (
    dump_camera_settings, load_camera_settings)
from bidirectional_pathtracing.scene.procedural import make_cornell_box


def test_round_trip(tmp_path):
    cam = make_cornell_box().camera
    p = str(tmp_path / "cam.txt")
    dump_camera_settings(cam, p, 480, 360)
    back = load_camera_settings(p)
    np.testing.assert_allclose(np.asarray(back.pos), np.asarray(cam.pos),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(back.c2w), np.asarray(cam.c2w),
                               rtol=1e-6)
    assert abs(float(back.hfov) - float(cam.hfov)) < 1e-4
    assert abs(float(back.nclip) - float(cam.nclip)) < 1e-6


def test_reads_reference_style_file(tmp_path):
    """A file in the exact reference dump layout parses correctly."""
    p = str(tmp_path / "ref.txt")
    with open(p, "w") as f:
        f.write("49.13 37.84 1.3333 0.1 100\n")
        f.write("0 0.75 4.8 0 0.75 0\n")
        f.write("1.5708 0 4.8 0.24 48\n")
        f.write("1 0 0 0 1 0 0 0 1\n")
        f.write("480 360 875.1\n")
        f.write("4.7 0.25\n")
    cam = load_camera_settings(p)
    assert abs(float(cam.hfov) - 49.13) < 1e-4
    np.testing.assert_allclose(np.asarray(cam.pos), [0, 0.75, 4.8])
    assert abs(float(cam.lens_radius) - 0.25) < 1e-6
