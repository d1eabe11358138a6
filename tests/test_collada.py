"""Golden-parse tests for the COLLADA loader against known scene content
(reference scenes under /root/reference/dae)."""

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")


def test_cbspheres_lambertian_structure(cbspheres_lambertian):
    scene, aux = cbspheres_lambertian
    assert aux["num_tris"] == 12
    assert aux["num_spheres"] == 2
    L = scene.lights
    assert L.kind.shape[0] == 1
    np.testing.assert_allclose(np.asarray(L.radiance[0]), [10, 10, 10])
    np.testing.assert_allclose(np.asarray(L.position[0]), [0, 1.49, 0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(L.direction[0]), [0, -1, 0],
                               atol=1e-6)
    # dims: 0.6 x 0.8 rect (gl_scene/area_light.h transform)
    assert abs(float(L.area[0]) - 0.48) < 1e-5
    # spheres at (+-0.4, 0.3, +-0.3) r=0.3
    c = np.sort(np.asarray(scene.geometry.sph_c), axis=0)
    np.testing.assert_allclose(c[:, 1], [0.3, 0.3], atol=1e-6)
    np.testing.assert_allclose(np.asarray(scene.geometry.sph_r), [0.3, 0.3],
                               atol=1e-6)


def test_camera_placement(cbspheres_lambertian):
    scene, aux = cbspheres_lambertian
    cam = scene.camera
    # Application::load places the camera from the scene bbox;
    # CBspheres box => pos (0, 0.75, 4.8023) looking -z.
    np.testing.assert_allclose(np.asarray(cam.pos), [0, 0.75, 4.8023443],
                               atol=1e-4)
    # effective FOV comes from configure@800x600 + set_screen_size(120,90)
    # (application.cpp:97,188-191; camera.cpp:83-89)
    import math
    screen_dist = 600 / (2 * math.tan(math.radians(37.8492955) / 2))
    hfov = math.degrees(2 * math.atan(120 / (2 * screen_dist)))
    assert abs(float(cam.hfov) - hfov) < 1e-3


def test_vertex_normals_point_inward(cbspheres_lambertian):
    """The halfedge boundary walk flips open-mesh normals into the box
    (validated against the reference oracle; see scene/halfedge.py)."""
    scene, aux = cbspheres_lambertian
    tp = np.asarray(scene.geometry.tri_p)
    tn = np.asarray(scene.geometry.tri_n)
    center = np.array([0.0, 0.75, 0.0])
    for i in range(aux["num_tris"]):
        centroid = tp[i].mean(0)
        to_center = center - centroid
        n = tn[i].mean(0)
        if np.linalg.norm(n) < 0.5:
            continue
        # every wall normal faces the box center; the light quad faces up
        # (its AreaLight emits via the light table, not the mesh normal)
        inward = float(np.dot(n, to_center))
        mats = np.asarray(scene.geometry.tri_mat)
        is_light = aux["material_records"][mats[i]]["kind"] == 1
        if not is_light:
            assert inward > 0, (i, n, centroid)


def test_cbgems_malformed_matrix_loads():
    from bidirectional_pathtracing.scene.build import load_scene
    scene, aux = load_scene(f"{REFERENCE}/dae/sky/CBgems.dae", 120, 90)
    assert aux["num_tris"] > 100


def test_cbspheres_materials(cbspheres):
    scene, aux = cbspheres
    kinds = {rec["kind"] for rec in aux["material_records"]}
    # diffuse walls + emission light + mirror + glass spheres
    assert {0, 1, 2, 4}.issubset(kinds)
