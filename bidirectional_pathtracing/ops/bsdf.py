"""Vectorized BSDF table: eval / sample / pdf / emission for a wavefront.

Replaces the reference's virtual-dispatch BSDF hierarchy
(reference src/pathtracer/bsdf.{h,cpp}, advanced_bsdf.cpp) with masked
select over material kinds: every branch is cheap vector math computed for
all lanes, then gathered by the per-lane material kind.  All directions are
in the local shading frame (+z = shading normal), like the reference.

Semantics per kind (reference citations):
  DIFFUSE    f = albedo/pi one-sided (bsdf.cpp:52-61), cosine sampling
             (bsdf.cpp:66-77), pdf z/pi (bsdf.cpp:80-85)
  EMISSION   f = 0, cosine sampling, get_emission = radiance
             (bsdf.cpp:99-118)
  MIRROR     delta reflect, pdf coefficient 1, f = R/|cos| scaling
             (advanced_bsdf.cpp:17-35)
  REFRACTION Snell delta, f = T/|cos|/eta^2, TIR returns black
             (advanced_bsdf.cpp:163-184)
  GLASS      Schlick coin flip between reflect/refract, f carries the
             R / (1-R) factors, pdf coefficients R / 1-R
             (advanced_bsdf.cpp:202-259)
  MICROFACET Beckmann NDF + conductor Fresnel + Smith shadowing, NDF
             importance sampling (advanced_bsdf.cpp:48-141).  The reference
             leaves sample_pdf unimplemented (assert(0),
             advanced_bsdf.cpp:144-148); we implement the proper NDF pdf so
             microfacet materials work under BDPT MIS (documented upgrade).

Gradients: f/emission are differentiable w.r.t. the material table; sampled
directions and pdfs are detached at the integrator level (detached-sampling
estimator).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bidirectional_pathtracing.core.math import PI, reflect_local, refract_local
from bidirectional_pathtracing.core import samplers
from bidirectional_pathtracing.scene.types import (
    Materials,
    MAT_DIFFUSE, MAT_EMISSION, MAT_GLASS, MAT_MICROFACET, MAT_MIRROR,
    MAT_REFRACTION,
)


class BSDFSample(NamedTuple):
    wi: jnp.ndarray        # [S,3] local
    f: jnp.ndarray         # [S,3] BSDF value (with delta scalings folded in)
    pdf: jnp.ndarray       # [S]   solid-angle pdf (delta: discrete coefficient)
    is_delta: jnp.ndarray  # bool [S]


def gather(materials: Materials, mid):
    """Gather per-lane material params; mid: int32 [S] (clipped to range)."""
    m = jnp.clip(mid, 0, materials.count - 1)
    return jax.tree_util.tree_map(lambda a: a[m], materials)


def is_delta(materials: Materials, mid):
    kind = materials.kind[jnp.clip(mid, 0, materials.count - 1)]
    return ((kind == MAT_MIRROR) | (kind == MAT_REFRACTION)
            | (kind == MAT_GLASS)) & (mid >= 0)


def emission(materials: Materials, mid):
    """get_emission(); zero for non-emission kinds and invalid mids."""
    m = gather(materials, mid)
    e = jnp.where((m.kind == MAT_EMISSION)[..., None], m.emission, 0.0)
    return jnp.where((mid >= 0)[..., None], e, 0.0)


def _abs_cos(w):
    return jnp.abs(w[..., 2])


# --- Microfacet helpers (advanced_bsdf.cpp:48-141) -------------------------

def _beckmann_d(h, alpha):
    cos_t = jnp.clip(h[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    cos2 = cos_t * cos_t
    tan2 = (1.0 - cos2) / cos2
    return jnp.exp(-tan2 / (alpha * alpha)) / (PI * alpha * alpha * cos2 * cos2)


def _smith_lambda(w, alpha):
    cos_t = jnp.clip(w[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    theta = jnp.arccos(cos_t)
    a = 1.0 / (alpha * jnp.tan(theta))
    return 0.5 * (jax.scipy.special.erf(a) - 1.0
                  + jnp.exp(-a * a) / (a * PI))


def _conductor_fresnel(wi, eta, k):
    cos_t = _abs_cos(wi)[..., None]
    e2k2 = eta * eta + k * k
    c2 = cos_t * cos_t
    rs = (e2k2 - 2 * eta * cos_t + c2) / (e2k2 + 2 * eta * cos_t + c2)
    rp = (e2k2 * c2 - 2 * eta * cos_t + 1) / (e2k2 * c2 + 2 * eta * cos_t + 1)
    return (rs + rp) / 2


def _microfacet_f(m, wo, wi):
    h = wo + wi
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
    alpha = m.roughness
    val = (_conductor_fresnel(wi, m.eta, m.k)
           * (1.0 / (1.0 + _smith_lambda(wi, alpha) + _smith_lambda(wo, alpha)))[..., None]
           * _beckmann_d(h, alpha)[..., None]
           / (4.0 * wo[..., 2:3] * wi[..., 2:3]))
    good = (wo[..., 2] > 1e-5) & (wi[..., 2] > 1e-5)
    return jnp.where(good[..., None], val, 0.0)


def _microfacet_pdf(alpha, wo, wi):
    """NDF pdf of wi given wo: p(h)/(4 |wi.h|) with Beckmann p(h)=D(h)|cos h|."""
    h = wo + wi
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
    pdf_h = _beckmann_d(h, alpha) * jnp.abs(h[..., 2])
    denom = 4.0 * jnp.abs(jnp.sum(wi * h, axis=-1))
    pdf = pdf_h / jnp.maximum(denom, 1e-12)
    good = (wo[..., 2] > 1e-5) & (wi[..., 2] > 1e-5)
    return jnp.where(good, pdf, 0.0)


def _schlick(m, wo_side_z, cos_refract):
    """R per Schlick (advanced_bsdf.cpp:219-224); eta from the wo side."""
    eta = jnp.where(wo_side_z > 0, 1.0 / m.ior, m.ior)
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    r = r0 + (1.0 - r0) * (1.0 - cos_refract) ** 5
    return r, eta


# --- public API -------------------------------------------------------------

def eval_f(materials: Materials, mid, wo, wi):
    """BSDF::f for non-delta kinds; deltas and invalid lanes return 0."""
    m = gather(materials, mid)
    # diffuse (one-sided: both z >= 0, bsdf.cpp:56-58)
    f_diff = jnp.where(
        ((wo[..., 2] >= 0) & (wi[..., 2] >= 0))[..., None],
        m.albedo / PI, 0.0)
    f_micro = _microfacet_f(m, wo, wi)
    f = jnp.where((m.kind == MAT_DIFFUSE)[..., None], f_diff, 0.0)
    f = jnp.where((m.kind == MAT_MICROFACET)[..., None], f_micro, f)
    return jnp.where((mid >= 0)[..., None], f, 0.0)


def sample(materials: Materials, mid, wo, u, adjoint: bool = False) -> BSDFSample:
    """BSDF::sample_f for a wavefront.

    u: uniforms [S,3] — u[...,0:2] drive direction sampling, u[...,2] the
    glass reflect/refract coin flip (coin_flip(R), advanced_bsdf.cpp:225).

    adjoint: set for LIGHT-subpath walks, where `wo` is the arrival
    direction from the light side.  Every reference BSDF value is
    symmetric in (wo, wi) — diffuse, and the delta kinds whose f the
    reference defines pairwise — EXCEPT microfacet, whose conductor
    Fresnel uses the wi slot only (advanced_bsdf.cpp:120: F(wi)).  The
    path integrand needs the Fresnel of the light-side direction, so the
    adjoint evaluation swaps the microfacet f's arguments (Veach 5.2
    adjoint BSDF); sampling pdfs/directions are unchanged.  Without this
    the light-walk throughput carries F(toward-camera) and BDPT diverges
    from PT on microfacet scenes.
    """
    m = gather(materials, mid)
    u2 = u[..., 0:2]

    # cosine-weighted candidate (diffuse + emission; bsdf.cpp:66-77)
    wi_cos, pdf_cos = samplers.cosine_hemisphere(u2)

    # mirror reflect (advanced_bsdf.cpp:21-29)
    wi_ref = reflect_local(wo)
    f_mirror = m.reflectance / jnp.maximum(_abs_cos(wi_ref), 1e-12)[..., None]

    # refraction (advanced_bsdf.cpp:167-178)
    wi_refr, refr_ok = refract_local(wo, m.ior)
    eta_wo = jnp.where(wo[..., 2] > 0, 1.0 / m.ior, m.ior)
    f_refr = (m.transmittance
              / jnp.maximum(_abs_cos(wi_refr), 1e-12)[..., None]
              / (eta_wo * eta_wo)[..., None])
    f_refr = jnp.where(refr_ok[..., None], f_refr, 0.0)

    # glass (advanced_bsdf.cpp:202-236)
    r_schlick, _ = _schlick(m, wo[..., 2], _abs_cos(wi_refr))
    choose_reflect = (~refr_ok) | (u[..., 2] < r_schlick)
    r_eff = jnp.where(refr_ok, r_schlick, 1.0)
    wi_glass = jnp.where(choose_reflect[..., None], wi_ref, wi_refr)
    f_glass_ref = r_eff[..., None] * m.reflectance / jnp.maximum(
        _abs_cos(wi_ref), 1e-12)[..., None]
    # TIR: pdf 1, plain reflectance/|cos| (advanced_bsdf.cpp:213-218)
    f_glass_ref = jnp.where(refr_ok[..., None], f_glass_ref,
                            m.reflectance / jnp.maximum(
                                _abs_cos(wi_ref), 1e-12)[..., None])
    f_glass_refr = ((1.0 - r_eff)[..., None] * m.transmittance
                    / jnp.maximum(_abs_cos(wi_refr), 1e-12)[..., None]
                    / (eta_wo * eta_wo)[..., None])
    f_glass = jnp.where(choose_reflect[..., None], f_glass_ref, f_glass_refr)
    pdf_glass = jnp.where(choose_reflect, jnp.where(refr_ok, r_eff, 1.0),
                          1.0 - r_eff)

    # microfacet NDF sampling (advanced_bsdf.cpp:94-141)
    alpha = m.roughness
    theta_h = jnp.arctan(
        jnp.sqrt(jnp.maximum(-alpha * alpha * jnp.log1p(-u2[..., 0]), 0.0)))
    phi_h = 2.0 * PI * u2[..., 1]
    h = jnp.stack([jnp.sin(theta_h) * jnp.cos(phi_h),
                   jnp.sin(theta_h) * jnp.sin(phi_h),
                   jnp.cos(theta_h)], axis=-1)
    wi_mf = 2.0 * jnp.sum(wo * h, axis=-1)[..., None] * h - wo
    wi_mf = wi_mf / jnp.maximum(
        jnp.linalg.norm(wi_mf, axis=-1, keepdims=True), 1e-20)
    mf_ok = (wo[..., 2] > 1e-5) & (wi_mf[..., 2] > 1e-5)
    pdf_mf = _microfacet_pdf(alpha, wo, wi_mf)
    wi_mf = jnp.where(mf_ok[..., None], wi_mf,
                      jnp.array([0.0, 0.0, 1.0]))
    pdf_mf = jnp.where(mf_ok, jnp.maximum(pdf_mf, 1e-12), 1.0)
    f_mf_val = (_microfacet_f(m, wi_mf, wo) if adjoint
                else _microfacet_f(m, wo, wi_mf))
    f_mf = jnp.where(mf_ok[..., None], f_mf_val, 0.0)

    kind = m.kind
    wi = wi_cos
    wi = jnp.where((kind == MAT_MIRROR)[..., None], wi_ref, wi)
    wi = jnp.where((kind == MAT_REFRACTION)[..., None],
                   jnp.where(refr_ok[..., None], wi_refr, wi_ref), wi)
    wi = jnp.where((kind == MAT_GLASS)[..., None], wi_glass, wi)
    wi = jnp.where((kind == MAT_MICROFACET)[..., None], wi_mf, wi)

    f_diff = jnp.where(((wo[..., 2] >= 0) & (wi_cos[..., 2] >= 0))[..., None],
                       m.albedo / PI, 0.0)
    f = jnp.where((kind == MAT_DIFFUSE)[..., None], f_diff, 0.0)
    f = jnp.where((kind == MAT_MIRROR)[..., None], f_mirror, f)
    f = jnp.where((kind == MAT_REFRACTION)[..., None],
                  jnp.where(refr_ok[..., None], f_refr, 0.0), f)
    f = jnp.where((kind == MAT_GLASS)[..., None], f_glass, f)
    f = jnp.where((kind == MAT_MICROFACET)[..., None], f_mf, f)

    pdf = pdf_cos
    pdf = jnp.where(kind == MAT_MIRROR, 1.0, pdf)
    pdf = jnp.where(kind == MAT_REFRACTION, 1.0, pdf)
    pdf = jnp.where(kind == MAT_GLASS, pdf_glass, pdf)
    pdf = jnp.where(kind == MAT_MICROFACET, pdf_mf, pdf)
    pdf = jnp.maximum(pdf, 1e-12)

    delta = ((kind == MAT_MIRROR) | (kind == MAT_REFRACTION)
             | (kind == MAT_GLASS))
    # Detached-sampling estimator: the sampled direction and its pdf are
    # treated as constants under differentiation; parameter gradients flow
    # only through the BSDF value f (and radiance terms downstream).
    return BSDFSample(wi=jax.lax.stop_gradient(wi), f=f,
                      pdf=jax.lax.stop_gradient(pdf),
                      is_delta=delta & (mid >= 0))


def sample_pdf(materials: Materials, mid, wo, wi):
    """BSDF::sample_pdf — the MIS pdf contract (bsdf.h:71-110).

    DIFFUSE/EMISSION: cosine pdf of wi.  MIRROR/REFRACTION: 1.
    GLASS: Schlick R for wi.z>0 else 1-R (advanced_bsdf.cpp:239-259;
    matching the reference's eta convention when invoked from MIS with an
    empty wo: eta = ior).

    MICROFACET: the cosine-hemisphere pdf as a wo-INDEPENDENT proxy —
    this function keeps the reference's zero-wo calling contract
    (bidirection.cpp:150 "filled with empty for now"), under which the
    true NDF pdf is uncomputable (it needs the half vector).  BDPT MIS
    does NOT use this for pricing: it calls mis_pdf() below with the true
    arrival direction (the proxy was measured +22% bright under BDPT —
    support mismatch with the NDF sampler; see mis_pdf's docstring).
    """
    m = gather(materials, mid)
    kind = m.kind
    pdf = samplers.cosine_hemisphere_pdf(wi)
    pdf = jnp.where(kind == MAT_MIRROR, 1.0, pdf)
    pdf = jnp.where(kind == MAT_REFRACTION, 1.0, pdf)

    # glass: refract wi (treated as the incoming dir, advanced_bsdf.cpp:239-253)
    wo_refr, refr_ok = refract_local(wi, m.ior)
    eta = m.ior  # reference quirk: wo is empty => wo.z>0 false => eta=ior
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    r = r0 + (1.0 - r0) * (1.0 - _abs_cos(wo_refr)) ** 5
    glass_pdf = jnp.where(refr_ok, jnp.where(wi[..., 2] > 0, r, 1.0 - r), 1.0)
    pdf = jnp.where(kind == MAT_GLASS, glass_pdf, pdf)

    pdf = jnp.where(kind == MAT_MICROFACET,
                    samplers.cosine_hemisphere_pdf(jnp.abs(wi)), pdf)
    return jnp.where(mid >= 0, pdf, 0.0)


def mis_pdf(materials: Materials, mid, wo, wi):
    """MIS edge pdf with the TRUE arrival direction wo.

    Identical to sample_pdf for every reference BSDF kind (their MIS pdfs
    are wo-independent: cosine / 1 / Schlick-R), but MICROFACET uses the
    true Beckmann NDF pdf p(h)/(4|wi.h|), zero outside the sampler's
    support (wo.z>0 and wi.z>0, mirroring sample()'s mf_ok gate).  The
    reference cannot do this — its MIS walk only has the edge direction,
    so it calls sample_pdf(wo=empty) (bidirection.cpp:150); our vectorized
    walk knows every path vertex, so each strategy's pdf product is priced
    with the exact pdfs that strategy would sample with — the Veach-exact
    weighting.  A wo-independent cosine proxy was tried first and is
    provably partition-preserving but measured +22% bright on
    CBspheres_microfacet (support mismatch: the proxy prices
    below-horizon / through-surface edges the NDF sampler never takes, and
    each strategy's own denominator then disagrees with how alternatives
    price it).  Pinned by tests/test_mis.py microfacet partition cases and
    tests/test_microfacet.py::test_microfacet_bdpt_matches_pt.
    """
    m = gather(materials, mid)
    kind = m.kind
    pdf = sample_pdf(materials, mid, jnp.zeros_like(wi), wi)
    pdf = jnp.where(kind == MAT_MICROFACET,
                    _microfacet_pdf(m.roughness, wo, wi), pdf)
    return jnp.where(mid >= 0, pdf, 0.0)
