"""Vectorized geometry helpers shared by all integrators.

Numerical semantics follow the reference CGL library:
  - make_coord_space: reference src/pathtracer/bsdf.cpp:21-41
  - reflect/refract:  reference src/pathtracer/advanced_bsdf.cpp:272-303
  - luminance:        reference CGL/include/CGL/vector3D.h:231 (illum())
All functions are batched: vectors have shape [..., 3] and operate elementwise
over leading dims, so they vectorize over the whole sample wavefront.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = jnp.pi
EPS_F = 1e-5          # reference CGL/include/CGL/misc.h (EPS_F = 1e-5 float)
INF_D = 1e30

# Rec.709 luma weights used by Vector3D::illum() in the reference.
# numpy (not jnp) so importing inside a trace can't leak a tracer.
import numpy as _np  # noqa: E402
_LUMA = _np.array([0.2126, 0.7152, 0.0722], dtype=_np.float32)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def norm(v):
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), 0.0))


def norm2(v):
    return jnp.sum(v * v, axis=-1)


def normalize(v, eps: float = 1e-20):
    return v / jnp.maximum(norm(v), eps)[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def luminance(c):
    """Vector3D::illum(): 0.2126 r + 0.7152 g + 0.0722 b."""
    return jnp.sum(c * _LUMA, axis=-1)


def make_coord_space(n):
    """Build an orthonormal frame with +z == n.

    Returns o2w with shape [..., 3, 3]; columns are (x, y, z=n) so that
    ``world = o2w @ local``.  Matches the reference construction
    (bsdf.cpp:21-41): h = n with its smallest-|component| set to 1,
    y = normalize(h x z), x = normalize(z x y).
    """
    z = normalize(n)
    an = jnp.abs(n)
    # index of the smallest absolute component, with the reference's tie rule:
    # x wins ties against y and z; y wins ties against z.
    ax, ay, az = an[..., 0], an[..., 1], an[..., 2]
    pick_x = (ax <= ay) & (ax <= az)
    pick_y = (~pick_x) & (ay <= az)
    h = jnp.stack(
        [
            jnp.where(pick_x, 1.0, n[..., 0]),
            jnp.where(pick_y, 1.0, n[..., 1]),
            jnp.where(~(pick_x | pick_y), 1.0, n[..., 2]),
        ],
        axis=-1,
    )
    y = normalize(jnp.cross(h, z))
    x = normalize(jnp.cross(z, y))
    # o2w columns are the basis vectors (reference stores them as columns:
    # o2w[i] accesses column i of Matrix3x3).
    return jnp.stack([x, y, z], axis=-1)


def mat_vec(m, v):
    """m @ v for [..., 3, 3] (or [3, 3]) m and [..., 3] v, as elementwise
    f32 products and sums: a dot here may run in TF32 on GPUs, which keeps
    only ~3 decimal digits of the geometry."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def to_local(o2w, v_world):
    """w2o = o2w^T applied to v: local = o2w^T v."""
    return jnp.sum(o2w * v_world[..., :, None], axis=-2)


def to_world(o2w, v_local):
    return mat_vec(o2w, v_local)


def reflect_local(wo):
    """Mirror reflection about local normal (0,0,1); advanced_bsdf.cpp:272-278."""
    return jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)


def refract_local(wo, ior):
    """Snell refraction in the local frame; advanced_bsdf.cpp:280-303.

    Returns (wi, ok) where ok=False marks total internal reflection.
    ``ior`` broadcasts against wo's leading dims.
    """
    enter = wo[..., 2] > 0
    eta = jnp.where(enter, 1.0 / ior, ior)
    z_sq = 1.0 - eta * eta * (1.0 - wo[..., 2] * wo[..., 2])
    ok = z_sq >= 0
    sgn = jnp.where(enter, -1.0, 1.0)
    z = sgn * jnp.sqrt(jnp.maximum(z_sq, 0.0))
    wi = jnp.stack([-eta * wo[..., 0], -eta * wo[..., 1], z], axis=-1)
    return wi, ok
