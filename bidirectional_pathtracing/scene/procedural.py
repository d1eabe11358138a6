"""Procedural test scenes (no .dae required).

Used by the multichip dry-run, benchmarks, chip_smoke.py and tests.  The
Cornell box here is built from scratch with inward normals and an area
light, shaped like the classic CBspheres layout but with our own
construction; `make_icosphere_box` puts a closed mesh of chosen size in it.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from bidirectional_pathtracing.scene.types import (
    Camera, Scene, LIGHT_AREA, MAT_DIFFUSE, MAT_EMISSION, MAT_GLASS,
    MAT_MICROFACET, MAT_MIRROR, make_geometry, make_lights, make_materials,
)


def _quad(p0, p1, p2, p3, n):
    """Two triangles for a quad with a shared normal."""
    tris = [[p0, p1, p2], [p0, p2, p3]]
    norms = [[n, n, n], [n, n, n]]
    return tris, norms


_MATERIALS = [
    {"kind": MAT_DIFFUSE, "albedo": np.array([0.6, 0.6, 0.6])},   # 0 gray
    {"kind": MAT_DIFFUSE, "albedo": np.array([0.6, 0.2, 0.2])},   # 1 red
    {"kind": MAT_DIFFUSE, "albedo": np.array([0.2, 0.2, 0.6])},   # 2 blue
    {"kind": MAT_EMISSION, "emission": np.array([10.0, 10.0, 10.0])},  # 3
    {"kind": MAT_DIFFUSE, "albedo": np.array([0.8, 0.8, 0.8])},   # 4
    {"kind": MAT_MIRROR, "reflectance": np.array([0.9, 0.9, 0.9])},  # 5
    {"kind": MAT_GLASS, "transmittance": np.array([0.9, 0.9, 0.9]),
     "reflectance": np.array([0.9, 0.9, 0.9]), "ior": 1.45},      # 6
    {"kind": MAT_MICROFACET, "roughness": 0.3,                    # 7 Al
     "eta": np.array([1.345, 0.965, 0.617]),
     "k": np.array([7.47, 6.40, 5.30])},
]
_MAT_NAME_TO_ID = {"diffuse": 4, "mirror": 5, "glass": 6, "microfacet": 7}


def _box_walls():
    """Walls and light quad of the 2x1.5x2 box: (tris, norms, mats)."""
    tris, norms, mats = [], [], []

    def add_quad(p0, p1, p2, p3, n, mid):
        t, nn = _quad(np.array(p0, np.float64), np.array(p1, np.float64),
                      np.array(p2, np.float64), np.array(p3, np.float64),
                      np.array(n, np.float64))
        tris.extend(t)
        norms.extend(nn)
        mats.extend([mid, mid])

    # floor (y=0, normal +y), ceiling (y=1.5, -y), back (z=-1, +z),
    # left (x=-1, +x, red), right (x=1, -x, blue)
    add_quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], [0, 1, 0], 0)
    add_quad([-1, 1.5, -1], [-1, 1.5, 1], [1, 1.5, 1], [1, 1.5, -1],
             [0, -1, 0], 0)
    add_quad([-1, 0, -1], [-1, 1.5, -1], [1, 1.5, -1], [1, 0, -1],
             [0, 0, 1], 0)
    add_quad([-1, 0, -1], [-1, 0, 1], [-1, 1.5, 1], [-1, 1.5, -1],
             [1, 0, 0], 1)
    add_quad([1, 0, -1], [1, 1.5, -1], [1, 1.5, 1], [1, 0, 1],
             [-1, 0, 0], 2)
    # light quad just below the ceiling
    add_quad([-0.4, 1.49, -0.3], [0.4, 1.49, -0.3], [0.4, 1.49, 0.3],
             [-0.4, 1.49, 0.3], [0, -1, 0], 3)
    return tris, norms, mats


def _box_scene(geometry) -> Scene:
    """The box's materials, ceiling area light and camera around
    `geometry`."""
    lights = make_lights([{
        "kind": LIGHT_AREA,
        "radiance": np.array([10.0, 10.0, 10.0]),
        "position": np.array([0.0, 1.49, 0.0]),
        "direction": np.array([0.0, -1.0, 0.0]),
        "dim_x": np.array([0.8, 0.0, 0.0]),
        "dim_y": np.array([0.0, 0.0, 0.6]),
        "area": 0.48,
    }])

    # camera on the +z axis looking -z, like the reference placement
    c2w = np.eye(3)
    camera = Camera(
        c2w=jnp.asarray(c2w, jnp.float32),
        pos=jnp.asarray([0.0, 0.75, 4.0], jnp.float32),
        hfov=jnp.asarray(35.0, jnp.float32),
        vfov=jnp.asarray(27.0, jnp.float32),
        nclip=jnp.asarray(0.01, jnp.float32),
        fclip=jnp.asarray(100.0, jnp.float32),
        lens_radius=jnp.asarray(0.0, jnp.float32),
        focal_distance=jnp.asarray(4.0, jnp.float32),
    )
    return Scene(geometry=geometry, materials=make_materials(_MATERIALS),
                 lights=lights, camera=camera)


def make_cornell_box(width: int = 120, height: int = 90,
                     sphere_materials=("diffuse", "diffuse")) -> Scene:
    """A 2x1.5x2 Cornell box, open front (+z), two spheres, ceiling light."""
    tris, norms, mats = _box_walls()
    sph_c = [[-0.4, 0.3, -0.3], [0.4, 0.3, 0.3]]
    sph_r = [0.3, 0.3]
    sph_mat = [_MAT_NAME_TO_ID[m] for m in sphere_materials]
    geometry = make_geometry(np.array(tris), np.array(norms),
                             np.array(mats, np.int32),
                             np.array(sph_c), np.array(sph_r),
                             np.array(sph_mat, np.int32))
    return _box_scene(geometry)


def icosphere(level: int, seed: int = 0, jitter: float = 0.02):
    """Closed triangle mesh of the unit sphere: the icosahedron with each
    face split into 4, `level` times (20 * 4**level triangles).  Vertices
    are pushed back to the sphere after every split, then moved radially
    by up to +-jitter, drawn from `seed`.  Faces wind counter-clockwise
    seen from outside.  Returns (verts [V,3], faces [F,3] int)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
             [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
             [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        mid = {}

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[k] = len(verts) - 1
            return mid[k]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    verts = np.array(verts)
    rng = np.random.default_rng(seed)
    verts *= 1.0 + rng.uniform(-jitter, jitter, (len(verts), 1))
    return verts, np.array(faces, np.int64)


def make_icosphere_box(level: int, material: str = "diffuse", seed: int = 0,
                       width: int = 120, height: int = 90) -> Scene:
    """The Cornell box with a closed icosphere mesh (`icosphere`) in place
    of the two analytic spheres: 12 + 20 * 4**level triangles.

    Level 2 (332 tris) stays under brute_force_max_tris, so it exercises
    brute-force intersection; level 5 (20,492 tris) gets a BVH.  Vertex
    normals are the area-weighted face normals, all pointing outward.
    """
    tris, norms, mats = _box_walls()
    v, f = icosphere(level, seed)
    v = v * 0.45 + np.array([0.0, 0.5, 0.0])
    face_n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], face_n)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    tri_p = np.concatenate([np.array(tris), v[f]])
    tri_n = np.concatenate([np.array(norms), vn[f]])
    tri_mat = np.concatenate([np.array(mats, np.int32),
                              np.full(len(f), _MAT_NAME_TO_ID[material],
                                      np.int32)])
    return _box_scene(make_geometry(tri_p, tri_n, tri_mat))
