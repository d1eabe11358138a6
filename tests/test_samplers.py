"""Sampler pdf-consistency tests (the Sampler3D::pdf contract the reference
defines for BDPT MIS, reference src/pathtracer/sampler.h:68-69)."""

import jax
import jax.numpy as jnp
import numpy as np

from bidirectional_pathtracing.core import rng, samplers


def _u(n, seed=0, dims=2):
    return jax.random.uniform(jax.random.key(seed), (n, dims))


def _mc_integral(sample_fn, pdf_fn, f, n=200_000, seed=0):
    v = sample_fn(_u(n, seed))
    pdf = pdf_fn(v)
    vals = f(v) / jnp.maximum(pdf, 1e-12)
    return float(jnp.mean(vals))


def test_uniform_sphere_pdf_normalises():
    est = _mc_integral(samplers.uniform_sphere, samplers.uniform_sphere_pdf,
                       lambda v: jnp.ones(v.shape[:-1]))
    assert abs(est - 4 * np.pi) < 0.05


def test_uniform_hemisphere_pdf_normalises():
    est = _mc_integral(samplers.uniform_hemisphere,
                       samplers.uniform_hemisphere_pdf,
                       lambda v: jnp.ones(v.shape[:-1]))
    assert abs(est - 2 * np.pi) < 0.05


def test_cosine_hemisphere_matches_pdf():
    wi, pdf = samplers.cosine_hemisphere(_u(100_000, 1))
    np.testing.assert_allclose(np.asarray(pdf),
                               np.asarray(samplers.cosine_hemisphere_pdf(wi)),
                               rtol=1e-5, atol=1e-6)
    # cosine integral: E[cos/pdf] = integral of cos over hemisphere = pi
    est = float(jnp.mean(wi[..., 2] / jnp.maximum(pdf, 1e-12)))
    assert abs(est - np.pi) < 0.05


def test_samples_on_unit_sphere():
    for fn in (samplers.uniform_sphere, samplers.uniform_hemisphere):
        v = fn(_u(1000, 2))
        np.testing.assert_allclose(np.linalg.norm(np.asarray(v), axis=-1),
                                   1.0, atol=1e-5)


def test_per_lane_keys_deterministic_and_shard_invariant():
    """Counter-based streams depend only on (key, lane id), not on how the
    lane axis is partitioned — the property the SPMD renderer relies on."""
    key = jax.random.key(3)
    ids = jnp.arange(64, dtype=jnp.int32)
    keys = rng.lane_keys(key, ids)
    u_full = rng.uniform(rng.fold(keys, 7), (2,))
    # recompute on two "shards"
    u_a = rng.uniform(rng.fold(rng.lane_keys(key, ids[:32]), 7), (2,))
    u_b = rng.uniform(rng.fold(rng.lane_keys(key, ids[32:]), 7), (2,))
    np.testing.assert_array_equal(np.asarray(u_full),
                                  np.concatenate([u_a, u_b]))
