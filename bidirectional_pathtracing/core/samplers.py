"""Sampling primitives as pure functions of uniform numbers.

Each sampler mirrors a reference sampler (src/pathtracer/sampler.{h,cpp})
and exposes the pdf() contract needed by BDPT MIS (sampler.h:68-69):
  - uniform_sphere:          sampler.cpp:17-30   (pdf 1/4pi)
  - uniform_hemisphere:      sampler.cpp:36-61   (pdf 1/2pi for z>0)
  - cosine_hemisphere:       sampler.cpp:67-94   (pdf z/pi for z>0)

Samplers take uniforms u [.., 2] (generated from counter-based per-lane
keys via core.rng) rather than PRNG keys, so the sampling math is
decoupled from key plumbing and renders stay bitwise reproducible under
any sharding.
"""

from __future__ import annotations

import jax.numpy as jnp

from bidirectional_pathtracing.core.math import PI


def uniform_sphere(u):
    z = u[..., 0] * 2.0 - 1.0
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, z],
                     axis=-1)


def uniform_sphere_pdf(v):
    return jnp.full(v.shape[:-1], 0.25 / PI)


def uniform_hemisphere(u):
    cos_t = u[..., 0]
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t],
                     axis=-1)


def uniform_hemisphere_pdf(v):
    return jnp.where(v[..., 2] > 0, 0.5 / PI, 0.0)


def cosine_hemisphere(u):
    """Returns (wi, pdf).  pdf = sqrt(1-u1)/pi = z/pi (sampler.cpp:76-85)."""
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    z = jnp.sqrt(jnp.maximum(1.0 - u[..., 0], 0.0))
    wi = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), z], axis=-1)
    return wi, z / PI


def cosine_hemisphere_pdf(v):
    return jnp.where(v[..., 2] > 0, v[..., 2] / PI, 0.0)
