"""Smaller parity features: spot lights (zero-contribution stubs like the
reference, light.cpp:156-194), autofocus (pathtracer.cpp:342-349), and the
environment-light CDF debug image (environment_light.cpp:66-81)."""

import numpy as np
import jax
import jax.numpy as jnp

from bidirectional_pathtracing.config import RenderConfig
from bidirectional_pathtracing.scene.procedural import make_cornell_box
from bidirectional_pathtracing.scene.types import (
    LIGHT_SPOT, Lights, make_lights)
from bidirectional_pathtracing.utils.render import autofocus, render
import pytest


def _append_spot(lights: Lights) -> Lights:
    extra = make_lights([{
        "kind": LIGHT_SPOT, "radiance": np.array([5.0, 5.0, 5.0]),
        "position": np.array([0.0, 1.0, 0.0]),
        "direction": np.array([0.0, -1.0, 0.0]),
    }])
    return jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b], axis=0), lights, extra)


@pytest.mark.slow
def test_spot_light_contributes_zero_pt():
    """The reference SpotLight::sample_L returns zero (light.cpp:164-167);
    the PT NEE loop visits every light, so adding a spot light must leave
    the unidirectional image bit-identical."""
    box = make_cornell_box()
    with_spot = box._replace(lights=_append_spot(box.lights))
    cfg = RenderConfig(spp=2, max_ray_depth=2, width=16, height=12,
                       integrator="pt")
    a = render(box, cfg)
    b = render(with_spot, cfg)
    assert np.isfinite(b.combined).all()
    np.testing.assert_allclose(a.combined, b.combined, rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_spot_light_bdpt_finite_and_unbiased_direction():
    """Under BDPT the light-subpath start may pick the spot light (the
    reference would assert(0); we yield a zero-contribution subpath).  The
    render must stay finite and nonzero."""
    box = make_cornell_box()
    with_spot = box._replace(lights=_append_spot(box.lights))
    cfg = RenderConfig(spp=4, max_ray_depth=3, width=16, height=12,
                       integrator="bdpt")
    res = render(with_spot, cfg)
    assert np.isfinite(res.combined).all()
    assert res.combined.mean() > 0.0


def test_spot_light_scene_builds():
    """_build_light converts a COLLADA spot LightInfo (gl_scene/spot_light.h
    transform semantics) instead of raising."""
    from bidirectional_pathtracing.scene import collada as C
    from bidirectional_pathtracing.scene.build import _build_light

    info = C.LightInfo()
    info.light_type = C.LIGHT_SPOT
    info.spectrum = np.array([1.0, 2.0, 3.0])
    info.position = np.array([0.0, 0.0, 0.0])
    info.direction = np.array([0.0, 0.0, -1.0])
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    rec = _build_light(info, T)
    assert rec["kind"] == LIGHT_SPOT
    np.testing.assert_allclose(rec["position"], [1.0, 2.0, 3.0])
    np.testing.assert_allclose(rec["direction"], [0.0, 0.0, -1.0], atol=1e-7)


def test_autofocus_returns_hit_distance():
    box = make_cornell_box()
    w, h = 64, 48
    fd = autofocus(box, w / 2, h / 2, w, h)
    # the center ray hits inside the box: finite, positive, shorter than
    # a few box diagonals
    assert 0.1 < fd < 100.0
    # a ray through the same pixel must hit at exactly that t
    from bidirectional_pathtracing.ops import camera_ops
    from bidirectional_pathtracing.ops.intersect import scene_intersect
    o, d = camera_ops.generate_ray(box.camera, jnp.asarray([0.5]),
                                   jnp.asarray([0.5]))
    hit = scene_intersect(box, o, d, jnp.asarray([0.0]),
                          jnp.asarray([1e9]))
    assert bool(hit.valid[0])
    assert abs(float(hit.t[0]) - fd) < 1e-4


def test_probability_debug_image(tmp_path):
    from bidirectional_pathtracing.ops import envlight
    from bidirectional_pathtracing.utils.png import read_png

    rng = np.random.default_rng(0)
    data = rng.uniform(0.1, 2.0, size=(8, 16, 3))
    env = envlight.build_envmap(data)
    path = str(tmp_path / "probability_debug.png")
    envlight.save_probability_debug(env, path)
    img = read_png(path)
    assert img.shape == (8, 16, 4)
    # R = marginal row CDF: constant per row, nondecreasing down rows,
    # last row saturates to 255
    assert (img[..., 0] == img[..., 0:1, 0:1].repeat(16, 1)[..., 0]).any()
    r = img[..., 0].astype(int)
    assert (np.diff(r[:, 0]) >= 0).all()
    assert r[-1, 0] == 255
    # G = conditional CDF: nondecreasing along each row, ends at 255
    g = img[..., 1].astype(int)
    assert (np.diff(g, axis=1) >= -1).all()
    assert (g[:, -1] >= 254).all()
    assert (img[..., 2] == 0).all()
    assert (img[..., 3] == 255).all()
