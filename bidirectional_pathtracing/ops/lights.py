"""Vectorized scene lights, including the BDPT light-interface extensions.

Replaces the SceneLight virtual interface (reference src/scene/scene.h:35-58)
with masked dispatch over a light table.  Implements for AREA and POINT
lights the full BDPT contract — sample_Le (light-subpath start),
sample_Le_point (fresh s=1 connection point), sample_pdf, contain_point —
matching reference light.cpp:100-153 (point) and :197-284 (area); the other
kinds (directional/hemisphere) support NEE sample_L only, exactly the
capability split of the reference (which assert(0)s on their BDPT methods;
we return zero-pdf instead of crashing).

Reference quirk note: AreaLight::sample_L computes the solid-angle pdf
with an unnormalised direction in the cosine term (light.cpp:210-215:
pdf = d^2/(A*|dot(d,n)|) = d/(A cos)), and the unidirectional NEE caller
divides radiance by d^2 (pathtracer.cpp:143), making the area-light direct
estimator scale as 1/d^3 instead of 1/d^2.  The BDPT path does not use
sample_L and is physically consistent.  sample_L replicates the quirk by
default (reference_quirks=True) for image parity with the reference's
unidirectional renders; pass False for the physically correct estimator
(RenderConfig.pt_reference_nee controls this).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bidirectional_pathtracing.core.math import (
    EPS_F, INF_D, PI, make_coord_space, mat_vec, normalize, to_local,
    to_world,
)
from bidirectional_pathtracing.core import samplers
from bidirectional_pathtracing.scene.types import (
    Lights, LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE, LIGHT_POINT,
)

# InfiniteHemisphereLight sampleToWorld (light.cpp:55-60): local z -> world y.
# numpy (not jnp) so importing this module inside a trace can't leak a tracer.
import numpy as _np  # noqa: E402
_HEMI_TO_WORLD = _np.array([[1.0, 0.0, 0.0],
                            [0.0, 0.0, -1.0],
                            [0.0, 1.0, 0.0]], _np.float32)


def gather(lights: Lights, idx):
    i = jnp.clip(idx, 0, lights.count - 1)
    return jax.tree_util.tree_map(lambda a: a[i], lights)


def num_lights(lights: Lights) -> int:
    """Static count of lights (the table is unpadded)."""
    return lights.kind.shape[0]


class NEESample(NamedTuple):
    radiance: jnp.ndarray  # [S,3] incident radiance (falloff folded in)
    wi: jnp.ndarray        # [S,3] world, unit, toward the light
    dist: jnp.ndarray      # [S]   distance to the light (INF_D if at infinity)
    pdf: jnp.ndarray       # [S]   solid-angle pdf


def sample_L(lights: Lights, idx, p, u2, reference_quirks: bool = True) -> NEESample:
    """Next-event estimation sample toward light `idx` from point p [S,3].

    u2: uniforms [S,2] (rect point / hemisphere direction).
    With reference_quirks=True (default), the AREA branch reproduces the
    reference's estimator exactly: pdf computed with the unnormalised
    direction in the cosine term (light.cpp:210-215) and radiance divided
    by dist^2 by the caller (pathtracer.cpp:143) — folded into `radiance`
    here.  With False, uses the physically standard solid-angle pdf.
    """
    li = gather(lights, idx)
    u = u2 - 0.5

    # AREA (light.cpp:205-217)
    pt = li.position + u[..., 0:1] * li.dim_x + u[..., 1:2] * li.dim_y
    d = pt - p
    sq = jnp.sum(d * d, axis=-1)
    dist_a = jnp.sqrt(jnp.maximum(sq, 1e-20))
    wi_a = d / dist_a[..., None]
    cos_l = jnp.sum(wi_a * li.direction, axis=-1)
    if reference_quirks:
        # pdf = |d|^2 / (A * |dot(d_unnormalised, n)|) = d/(A cos);
        # caller's L/d^2 folded into the returned radiance.
        pdf_a = sq / jnp.maximum(
            li.area * jnp.abs(cos_l) * dist_a, 1e-12)
        rad_scale = 1.0 / jnp.maximum(sq, 1e-12)
    else:
        pdf_a = sq / jnp.maximum(li.area * jnp.abs(cos_l), 1e-12)
        rad_scale = jnp.ones_like(sq)
    rad_a = jnp.where((cos_l < 0)[..., None],
                      li.radiance * rad_scale[..., None], 0.0)

    # POINT (light.cpp:105-113): pdf 1; apply inverse-square here so the
    # caller needs no special case (pathtracer.cpp:143 semantics).
    d_p = li.position - p
    dist_p = jnp.linalg.norm(d_p, axis=-1)
    wi_p = d_p / jnp.maximum(dist_p, 1e-20)[..., None]
    rad_p = li.radiance / jnp.maximum(dist_p * dist_p, 1e-12)[..., None]

    # DIRECTIONAL (light.cpp:17-23): stored direction = dir_to_light
    wi_d = jnp.broadcast_to(normalize(li.direction), p.shape)

    # HEMISPHERE (light.cpp:62-70)
    dir_h = samplers.uniform_hemisphere(u2)
    wi_h = mat_vec(_HEMI_TO_WORLD, dir_h)

    kind = li.kind
    # Default wi is a unit axis (not zero) so unsupported kinds — SPOT is an
    # empty stub in the reference (light.cpp:156-194) and contributes zero
    # radiance — still produce a non-degenerate shadow ray.
    z_axis = jnp.zeros_like(p).at[..., 2].set(1.0)
    wi = jnp.where((kind == LIGHT_AREA)[..., None], wi_a, z_axis)
    wi = jnp.where((kind == LIGHT_POINT)[..., None], wi_p, wi)
    wi = jnp.where((kind == LIGHT_DIRECTIONAL)[..., None], wi_d, wi)
    wi = jnp.where((kind == LIGHT_HEMISPHERE)[..., None], wi_h, wi)
    rad = jnp.where((kind == LIGHT_AREA)[..., None], rad_a, 0.0)
    rad = jnp.where((kind == LIGHT_POINT)[..., None], rad_p, rad)
    rad = jnp.where((kind == LIGHT_DIRECTIONAL)[..., None], li.radiance, rad)
    rad = jnp.where((kind == LIGHT_HEMISPHERE)[..., None], li.radiance, rad)
    dist = jnp.where(kind == LIGHT_AREA, dist_a,
                     jnp.where(kind == LIGHT_POINT, dist_p, INF_D))
    pdf = jnp.where(kind == LIGHT_AREA, pdf_a,
                    jnp.where(kind == LIGHT_HEMISPHERE, 0.5 / PI, 1.0))
    return NEESample(radiance=rad, wi=wi, dist=dist, pdf=pdf)


class LeSample(NamedTuple):
    radiance: jnp.ndarray   # [S,3]
    o: jnp.ndarray          # [S,3] emitted ray origin
    d: jnp.ndarray          # [S,3] emitted ray direction (unit, world)
    point_pdf: jnp.ndarray  # [S] area pdf of the origin (NOT yet / num_lights)
    dir_pdf: jnp.ndarray    # [S] solid-angle pdf of the direction
    normal: jnp.ndarray     # [S,3] light normal at the origin


def sample_Le(lights: Lights, idx, u_pt2, u_dir2) -> LeSample:
    """Emit a light-subpath start ray (SceneLight::sample_Le).

    AREA (light.cpp:219-232): uniform rect point (pdf 1/A) + cosine
    direction in the light frame.  POINT (light.cpp:115-123): the light
    position + uniform-sphere direction (pdf 1/4pi), normal = direction.
    Unsupported kinds return zero radiance / zero pdfs.
    """
    li = gather(lights, idx)
    u = u_pt2 - 0.5

    o_a = li.position + u[..., 0:1] * li.dim_x + u[..., 1:2] * li.dim_y
    d_local, dir_pdf_a = samplers.cosine_hemisphere(u_dir2)
    o2w = make_coord_space(li.direction)
    d_a = to_world(o2w, d_local)
    point_pdf_a = 1.0 / jnp.maximum(li.area, 1e-12)

    d_sph = samplers.uniform_sphere(u_dir2)

    kind = li.kind
    is_a = kind == LIGHT_AREA
    is_p = kind == LIGHT_POINT
    o = jnp.where(is_a[..., None], o_a, li.position)
    d = jnp.where(is_a[..., None], d_a, d_sph)
    point_pdf = jnp.where(is_a, point_pdf_a, jnp.where(is_p, 1.0, 0.0))
    dir_pdf = jnp.where(is_a, dir_pdf_a, jnp.where(is_p, 0.25 / PI, 0.0))
    normal = jnp.where(is_a[..., None], li.direction, d_sph)
    rad = jnp.where((is_a | is_p)[..., None], li.radiance, 0.0)
    return LeSample(radiance=rad, o=o, d=d, point_pdf=point_pdf,
                    dir_pdf=dir_pdf, normal=normal)


class LePointSample(NamedTuple):
    radiance: jnp.ndarray   # [S,3]
    wi: jnp.ndarray         # [S,3] unit, from p toward the light point
    point: jnp.ndarray      # [S,3] sampled light point
    dist: jnp.ndarray       # [S]
    point_pdf: jnp.ndarray  # [S]
    dir_pdf: jnp.ndarray    # [S] pdf of the light emitting toward p
    normal: jnp.ndarray     # [S,3]


def sample_Le_point(lights: Lights, idx, p, u2) -> LePointSample:
    """Fresh light point visible from p, for s=1 connections
    (SceneLight::sample_Le_point; area: light.cpp:234-255)."""
    li = gather(lights, idx)
    u = u2 - 0.5

    pt_a = li.position + u[..., 0:1] * li.dim_x + u[..., 1:2] * li.dim_y
    kind = li.kind
    is_a = kind == LIGHT_AREA
    is_p = kind == LIGHT_POINT
    point = jnp.where(is_a[..., None], pt_a, li.position)
    d = point - p
    sq = jnp.sum(d * d, axis=-1)
    dist = jnp.sqrt(jnp.maximum(sq, 1e-20))
    wi = d / dist[..., None]
    cos_l = jnp.sum(d * li.direction, axis=-1)

    o2w = make_coord_space(li.direction)
    dir_pdf_a = samplers.cosine_hemisphere_pdf(to_local(o2w, -wi))

    point_pdf = jnp.where(is_a, 1.0 / jnp.maximum(li.area, 1e-12),
                          jnp.where(is_p, 1.0, 0.0))
    dir_pdf = jnp.where(is_a, dir_pdf_a, jnp.where(is_p, 0.25 / PI, 0.0))
    normal = jnp.where(is_a[..., None], li.direction, -wi)
    rad_a = jnp.where((cos_l < 0)[..., None], li.radiance, 0.0)
    rad = jnp.where(is_a[..., None], rad_a,
                    jnp.where(is_p[..., None], li.radiance, 0.0))
    return LePointSample(radiance=rad, wi=wi, point=point, dist=dist,
                         point_pdf=point_pdf, dir_pdf=dir_pdf, normal=normal)


def contain_point(lights: Lights, idx, p):
    """SceneLight::contain_point.  AREA (light.cpp:257-262): plane test via
    |dot(normalize(position - p), direction)| < EPS.  POINT: |p-pos|<EPS."""
    li = gather(lights, idx)
    d = normalize(li.position - p)
    on_plane = jnp.abs(jnp.sum(d * li.direction, axis=-1)) < EPS_F
    near = jnp.linalg.norm(p - li.position, axis=-1) < EPS_F
    return jnp.where(li.kind == LIGHT_AREA, on_plane,
                     jnp.where(li.kind == LIGHT_POINT, near, False))


def sample_pdf(lights: Lights, idx, p, wi):
    """SceneLight::sample_pdf (area: light.cpp:264-284).

    Returns (radiance, point_pdf, dir_pdf) for a given point p on the light
    and world direction wi pointing TOWARD the light.  Zero when p is not
    on the light.
    """
    li = gather(lights, idx)
    contains = contain_point(lights, idx, p)
    o2w = make_coord_space(li.direction)
    dir_pdf_a = samplers.cosine_hemisphere_pdf(to_local(o2w, -wi))
    point_pdf = jnp.where(li.kind == LIGHT_AREA,
                          1.0 / jnp.maximum(li.area, 1e-12),
                          jnp.where(li.kind == LIGHT_POINT, 1.0, 0.0))
    dir_pdf = jnp.where(li.kind == LIGHT_AREA, dir_pdf_a,
                        jnp.where(li.kind == LIGHT_POINT, 0.25 / PI, 0.0))
    rad_a = jnp.where((dir_pdf_a > 0)[..., None], li.radiance, 0.0)
    rad = jnp.where((li.kind == LIGHT_AREA)[..., None], rad_a, li.radiance)
    point_pdf = jnp.where(contains, point_pdf, 0.0)
    dir_pdf = jnp.where(contains, dir_pdf, 0.0)
    rad = jnp.where(contains[..., None], rad, 0.0)
    return rad, point_pdf, dir_pdf
