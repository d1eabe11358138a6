"""Array-of-structs scene schema (JAX pytrees).

The reference keeps two pointer-based scene representations (an editable
GL/halfedge one and a flattened raytracer one; SURVEY.md L3/L4).  This
build needs only the flattened world-space form, stored as fixed-shape arrays
so the whole scene lives on device and is trivially replicated across a mesh.

Mirrors (for capability parity):
  - SceneObjects::Scene{objects, lights}      reference src/scene/scene.h:65-94
  - Triangle / Sphere primitives              src/scene/{triangle,sphere}.h
  - BSDF subclasses (6 kinds)                 src/pathtracer/bsdf.h:132-304
  - SceneLight implementations                src/scene/light.h:16-182
  - Camera                                    src/pathtracer/camera.h:18-126
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

# Material kinds (matching the 6 reference BSDF classes, bsdf.h:132-304)
MAT_DIFFUSE = 0
MAT_EMISSION = 1
MAT_MIRROR = 2
MAT_REFRACTION = 3
MAT_GLASS = 4
MAT_MICROFACET = 5

# Light kinds (light.h:16-182; env light handled separately)
LIGHT_AREA = 0
LIGHT_POINT = 1
LIGHT_DIRECTIONAL = 2
LIGHT_HEMISPHERE = 3
LIGHT_SPOT = 4


class Materials(NamedTuple):
    """Struct-of-arrays material table; every field has leading dim M.

    Differentiable fields: albedo, emission, reflectance, transmittance
    (the inverse-rendering parameters; gradients flow through shading).
    """

    kind: jnp.ndarray           # int32 [M]
    albedo: jnp.ndarray         # f32 [M,3]  diffuse reflectance
    emission: jnp.ndarray       # f32 [M,3]  emission radiance
    reflectance: jnp.ndarray    # f32 [M,3]  mirror/glass
    transmittance: jnp.ndarray  # f32 [M,3]  refraction/glass
    ior: jnp.ndarray            # f32 [M]
    roughness: jnp.ndarray      # f32 [M]    microfacet alpha
    eta: jnp.ndarray            # f32 [M,3]  microfacet conductor eta
    k: jnp.ndarray              # f32 [M,3]  microfacet conductor k

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Geometry(NamedTuple):
    """World-space triangle soup + analytic spheres.

    Triangles store pre-gathered vertices/normals (like the reference
    Triangle, which copies world-space data at construction;
    triangle.cpp:9-21).  Arrays are padded to static sizes; *_valid masks
    mark real primitives.  Global primitive ids are [0, T) triangles then
    [T, T+Q) spheres.
    """

    tri_p: jnp.ndarray       # f32 [T,3,3]  vertices p0,p1,p2
    tri_n: jnp.ndarray       # f32 [T,3,3]  vertex normals n0,n1,n2
    tri_mat: jnp.ndarray     # int32 [T]
    tri_valid: jnp.ndarray   # bool [T]
    sph_c: jnp.ndarray       # f32 [Q,3]
    sph_r: jnp.ndarray       # f32 [Q]
    sph_mat: jnp.ndarray     # int32 [Q]
    sph_valid: jnp.ndarray   # bool [Q]

    @property
    def num_tris(self) -> int:
        return self.tri_p.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_c.shape[0]


class Lights(NamedTuple):
    """Light table; leading dim L.  Fields are interpreted per kind:

    AREA   (light.cpp:197-284): radiance, position, direction (normal),
           dim_x, dim_y, area = |dim_x| |dim_y|
    POINT  (light.cpp:100-153): radiance, position
    DIRECTIONAL (light.cpp:9-51): radiance, direction = dir_to_light
    HEMISPHERE  (light.cpp:53-98): radiance
    """

    kind: jnp.ndarray       # int32 [L]
    radiance: jnp.ndarray   # f32 [L,3]
    position: jnp.ndarray   # f32 [L,3]
    direction: jnp.ndarray  # f32 [L,3]
    dim_x: jnp.ndarray      # f32 [L,3]
    dim_y: jnp.ndarray      # f32 [L,3]
    area: jnp.ndarray       # f32 [L]

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Camera(NamedTuple):
    """Pinhole (+thin lens) camera; camera.h:18-126.

    c2w columns are (right, up, back): the view direction is c2w @ (0,0,-1).
    hfov/vfov are in degrees (post aspect correction, camera.cpp:29-47).
    """

    c2w: jnp.ndarray      # f32 [3,3]
    pos: jnp.ndarray      # f32 [3]
    hfov: jnp.ndarray     # f32 [] degrees
    vfov: jnp.ndarray     # f32 [] degrees
    nclip: jnp.ndarray    # f32 []
    fclip: jnp.ndarray    # f32 []
    lens_radius: jnp.ndarray     # f32 []
    focal_distance: jnp.ndarray  # f32 []


class BVHArrays(NamedTuple):
    """Flattened BVH in pre-order with escape links (stackless traversal).

    Built host-side with the reference algorithm (spatial-midpoint split on
    the largest-extent centroid axis, leaves <= max_leaf_size; bvh.cpp:51-129)
    then linearised: node i's subtree occupies [i, escape[i]).
    """

    bounds_lo: jnp.ndarray   # f32 [N,3]
    bounds_hi: jnp.ndarray   # f32 [N,3]
    is_leaf: jnp.ndarray     # bool [N]
    prim_start: jnp.ndarray  # int32 [N]  index into prim_order
    prim_count: jnp.ndarray  # int32 [N]
    escape: jnp.ndarray      # int32 [N]  next pre-order node when skipping
    prim_order: jnp.ndarray  # int32 [P]  global prim ids in leaf order


class Envmap(NamedTuple):
    """HDR environment map with 2-stage CDF importance sampling
    (environment_light.cpp:18-62)."""

    data: jnp.ndarray        # f32 [H,W,3]
    pdf: jnp.ndarray         # f32 [H,W]   solid-angle-marginalised pixel pdf
    marginal_cdf: jnp.ndarray     # f32 [H]
    conditional_cdf: jnp.ndarray  # f32 [H,W]


class Scene(NamedTuple):
    geometry: Geometry
    materials: Materials
    lights: Lights
    camera: Camera
    bvh: Optional[BVHArrays] = None
    envmap: Optional[Envmap] = None


def _pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def make_geometry(tri_p, tri_n, tri_mat, sph_c=None, sph_r=None, sph_mat=None,
                  min_tris: int = 1, min_spheres: int = 1,
                  to_device: bool = True) -> Geometry:
    """Build padded Geometry from numpy arrays.

    to_device=False keeps numpy arrays — used while the host still needs
    the mesh (the BVH builder), avoiding a device->host round trip.
    """
    tri_p = np.asarray(tri_p, np.float32).reshape(-1, 3, 3)
    tri_n = np.asarray(tri_n, np.float32).reshape(-1, 3, 3)
    tri_mat = np.asarray(tri_mat, np.int32).reshape(-1)
    t = tri_p.shape[0]
    tp = max(t, min_tris)
    tri_valid = np.arange(tp) < t
    if sph_c is None:
        sph_c = np.zeros((0, 3), np.float32)
        sph_r = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)
    sph_c = np.asarray(sph_c, np.float32).reshape(-1, 3)
    sph_r = np.asarray(sph_r, np.float32).reshape(-1)
    sph_mat = np.asarray(sph_mat, np.int32).reshape(-1)
    q = sph_c.shape[0]
    qp = max(q, min_spheres)
    sph_valid = np.arange(qp) < q
    conv = jnp.asarray if to_device else np.asarray
    return Geometry(
        tri_p=conv(_pad_to(tri_p, tp)),
        tri_n=conv(_pad_to(tri_n, tp)),
        tri_mat=conv(_pad_to(tri_mat, tp)),
        tri_valid=conv(tri_valid),
        sph_c=conv(_pad_to(sph_c, qp)),
        sph_r=conv(_pad_to(sph_r, qp, fill=-1.0)),
        sph_mat=conv(_pad_to(sph_mat, qp)),
        sph_valid=conv(sph_valid),
    )


def make_materials(records) -> Materials:
    """records: list of dicts with keys kind + per-kind params."""
    m = max(len(records), 1)

    def field(name, dim, default):
        out = np.full((m, dim) if dim > 1 else (m,), default, np.float32)
        for i, r in enumerate(records):
            if name in r:
                out[i] = r[name]
        return jnp.asarray(out)

    kind = np.zeros((m,), np.int32)
    for i, r in enumerate(records):
        kind[i] = r["kind"]
    return Materials(
        kind=jnp.asarray(kind),
        albedo=field("albedo", 3, 0.0),
        emission=field("emission", 3, 0.0),
        reflectance=field("reflectance", 3, 0.0),
        transmittance=field("transmittance", 3, 0.0),
        ior=field("ior", 1, 1.45),
        roughness=field("roughness", 1, 0.1),
        eta=field("eta", 3, 1.0),
        k=field("k", 3, 0.0),
    )


def make_lights(records) -> Lights:
    # No padding: the static light count is Lights.kind.shape[0]; a scene
    # with zero lights gets zero-length arrays (callers branch on count).
    ell = len(records)

    def field(name, dim, default):
        out = np.full((ell, dim) if dim > 1 else (ell,), default, np.float32)
        for i, r in enumerate(records):
            if name in r:
                out[i] = r[name]
        return jnp.asarray(out)

    kind = np.full((ell,), -1, np.int32)
    for i, r in enumerate(records):
        kind[i] = r["kind"]
    return Lights(
        kind=jnp.asarray(kind),
        radiance=field("radiance", 3, 0.0),
        position=field("position", 3, 0.0),
        direction=field("direction", 3, 0.0),
        dim_x=field("dim_x", 3, 0.0),
        dim_y=field("dim_y", 3, 0.0),
        area=field("area", 1, 1.0),
    )
