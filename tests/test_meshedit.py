"""Halfedge edit ops + resampling (the reference's meshEdit.cpp API,
which it leaves as TODO stubs — ours are implemented and invariant-checked)."""

import numpy as np
import pytest

from bidirectional_pathtracing.scene.meshedit import HalfedgeMesh


def icosahedron():
    p = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
        [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
        [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]], float)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    return HalfedgeMesh.build(verts, faces)


def grid(n=4):
    """Flat triangulated n x n grid (open boundary)."""
    xs, ys = np.meshgrid(np.arange(n + 1), np.arange(n + 1))
    verts = np.stack([xs.ravel(), ys.ravel(),
                      np.zeros((n + 1) ** 2)], axis=1).astype(float)
    faces = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            b = a + 1
            c = a + n + 1
            d = c + 1
            faces.append((a, b, d))
            faces.append((a, d, c))
    return HalfedgeMesh.build(verts, faces)


def counts(m):
    return m.n_vertices(), m.n_edges(), m.n_faces()


def interior_edge(m):
    for e in m.edges:
        if not e.removed and not e.is_boundary():
            return e
    raise AssertionError("no interior edge")


def boundary_edge(m):
    for e in m.edges:
        if not e.removed and e.is_boundary():
            return e
    raise AssertionError("no boundary edge")


def test_build_counts_and_euler():
    m = icosahedron()
    assert counts(m) == (12, 30, 20)
    assert m.euler_characteristic() == 2
    m.validate()
    g = grid(3)
    g.validate()
    assert g.n_vertices() == 16
    assert g.n_faces() == 18
    # Euler with the boundary loop counted as a face: V - E + F = 2
    assert g.n_vertices() - g.n_edges() + g.n_faces(True) == 2


def test_flip_edge():
    m = icosahedron()
    e = interior_edge(m)
    a = e.halfedge.vertex
    b = e.halfedge.twin.vertex
    out = m.flip_edge(e)
    assert out is e
    m.validate()
    assert counts(m) == (12, 30, 20)
    # endpoints changed to the opposite pair
    na = e.halfedge.vertex
    nb = e.halfedge.twin.vertex
    assert {id(na), id(nb)} != {id(a), id(b)}
    g = grid(2)
    assert g.flip_edge(boundary_edge(g)) is None, "boundary flip is a no-op"
    g.validate()


def test_split_edge_interior():
    m = icosahedron()
    v0, e0, f0 = counts(m)
    e = interior_edge(m)
    pa = e.halfedge.vertex.position.copy()
    pb = e.halfedge.twin.vertex.position.copy()
    mv = m.split_edge(e)
    assert mv is not None and mv.is_new
    np.testing.assert_allclose(mv.position, (pa + pb) / 2)
    m.validate()
    assert counts(m) == (v0 + 1, e0 + 3, f0 + 2)
    assert m.euler_characteristic() == 2


def test_split_edge_boundary():
    g = grid(2)
    v0, e0, f0 = counts(g)
    e = boundary_edge(g)
    mv = g.split_edge(e)
    assert mv is not None
    g.validate()
    assert counts(g) == (v0 + 1, e0 + 2, f0 + 1)


def test_collapse_edge():
    m = icosahedron()
    m.upsample()  # more room to collapse safely
    v0, e0, f0 = counts(m)
    e = interior_edge(m)
    v = m.collapse_edge(e)
    assert v is not None
    m.validate()
    assert counts(m) == (v0 - 1, e0 - 3, f0 - 2)
    assert m.euler_characteristic() == 2


def test_collapse_refuses_nonmanifold():
    # tetrahedron: every collapse violates the link condition
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    faces = [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)]
    m = HalfedgeMesh.build(verts, faces)
    for e in list(m.edges):
        assert m.collapse_edge(e) is None
    m.validate()


def test_upsample_loop_subdivision():
    m = icosahedron()
    r_before = np.mean([np.linalg.norm(v.position) for v in m.vertices])
    m.upsample()
    m.validate()
    # V' = V + E, E' = 2E + 3F, F' = 4F
    assert counts(m) == (12 + 30, 2 * 30 + 3 * 20, 4 * 20)
    assert m.euler_characteristic() == 2
    # Loop subdivision of a convex blob shrinks it smoothly
    r_after = np.mean([np.linalg.norm(v.position) for v in m.vertices])
    assert 0.5 * r_before < r_after < r_before
    # valences: original vertices keep 5, new edge-vertices get 6
    vals = sorted(v.degree() for v in m.vertices)
    assert vals[:12] == [5] * 12 and vals[12:] == [6] * 30


def test_upsample_boundary_stays_planar():
    g = grid(2)
    g.upsample()
    g.validate()
    z = np.array([v.position[2] for v in g.vertices])
    assert np.abs(z).max() < 1e-12, "planar mesh must stay planar"
    # the 1D boundary rule: new boundary vertices are boundary-edge
    # midpoints (exactly on the outline); old ones follow the B-spline
    # rule (corners round inward but never leave the bounding square)
    for v in g.vertices:
        if not v.is_boundary():
            continue
        x, y = v.position[:2]
        assert -1e-9 <= x <= 2 + 1e-9 and -1e-9 <= y <= 2 + 1e-9
        if v.is_new:
            on_edge = (abs(x) < 1e-9 or abs(x - 2) < 1e-9
                       or abs(y) < 1e-9 or abs(y - 2) < 1e-9)
            assert on_edge


def test_downsample_quadric():
    m = icosahedron()
    m.upsample()
    m.upsample()          # 320 faces
    f0 = m.n_faces()
    m.downsample()
    m.validate()
    assert m.n_faces() <= f0 // 3
    assert m.euler_characteristic() == 2
    # geometry stays near the unit-ish sphere (QEM keeps shape)
    r = np.array([np.linalg.norm(v.position) for v in m.vertices])
    assert r.min() > 0.5 and r.max() < 2.5


def test_resample_uniformizes_edge_lengths():
    m = icosahedron()
    m.upsample()
    # distort: stretch along x to create nonuniform edges
    for v in m.vertices:
        v.position[0] *= 3.0
    lens0 = np.array([e.length() for e in m.edges if not e.removed])
    m.resample(iterations=3)
    m.validate()
    lens1 = np.array([e.length() for e in m.edges if not e.removed])
    assert lens1.std() / lens1.mean() < lens0.std() / lens0.mean()


def test_to_arrays_roundtrip():
    m = icosahedron()
    m.upsample()
    pos, tris = m.to_arrays()
    assert tris.shape[1] == 3
    m2 = HalfedgeMesh.from_arrays(pos, tris)
    m2.validate()
    assert counts(m2) == counts(m)


def test_scene_build_with_mesh_ops():
    """--upsample via load_scene: Cornell walls subdivide into more
    triangles and the scene still renders."""
    import os
    if not os.path.isdir("/root/reference"):
        pytest.skip("reference scenes not mounted")
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.build import load_scene
    from bidirectional_pathtracing.utils.render import render

    path = "/root/reference/dae/sky/CBspheres_lambertian.dae"
    base, aux0 = load_scene(path, 32, 24)
    up, aux1 = load_scene(path, 32, 24, mesh_ops=("upsample",))
    assert aux1["num_tris"] > 3 * aux0["num_tris"]
    res = render(up, RenderConfig(spp=2, max_ray_depth=2, width=32,
                                  height=24, integrator="pt"))
    assert np.isfinite(res.combined).all()
    assert res.combined.mean() > 0.01
