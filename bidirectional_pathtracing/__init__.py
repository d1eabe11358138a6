"""Differentiable bidirectional path tracer in JAX.

A brand-new JAX/XLA/Pallas implementation with the capabilities of the
reference CPU renderer (dongmingli-Ben/bidirectional-pathtracing): a Veach
bidirectional path tracer with multiple importance sampling, a unidirectional
path tracer with next-event estimation, the six CGL BSDFs, COLLADA scene
loading, environment lights, and multi-chip SPMD rendering via jax.sharding.

Design: wavefront SPMD.  All per-sample state lives in fixed-shape arrays;
the bounce loop is lax.scan; intersection runs as a brute-force Pallas
kernel on the GPU for small scenes and as a BVH walk for large ones, with
a plain jnp reference path; BSDF/light/MIS math is fully vectorized; rendering is pure
and deterministic via counter-based PRNG keys, so any device-mesh sharding
produces bitwise-identical images.
"""

__version__ = "0.1.0"

from bidirectional_pathtracing.config import RenderConfig  # noqa: F401
