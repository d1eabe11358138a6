"""The procedural icosphere mesh and the box that holds it."""

import numpy as np
import pytest

from bidirectional_pathtracing.scene.procedural import (
    icosphere, make_icosphere_box)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_icosphere_counts_and_closed(level):
    v, f = icosphere(level, seed=level)
    assert len(f) == 20 * 4 ** level
    assert len(v) == 10 * 4 ** level + 2          # Euler: V - E + F = 2
    # closed and consistently wound: every directed edge appears once and
    # its reverse appears once
    edges = [(a, b) for tri in f for a, b in zip(tri, np.roll(tri, -1))]
    assert len(set(edges)) == len(edges)
    assert set(edges) == {(b, a) for a, b in edges}


def test_icosphere_outward_and_seeded():
    v, f = icosphere(3, seed=7)
    r = np.linalg.norm(v, axis=1)
    assert (np.abs(r - 1.0) <= 0.02 + 1e-12).all()
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert (np.sum(fn * v[f].mean(axis=1), axis=1) > 0).all()
    np.testing.assert_array_equal(icosphere(3, seed=7)[0], v)
    assert not np.array_equal(icosphere(3, seed=8)[0], v)


@pytest.mark.parametrize("level,material", [(2, "diffuse"), (3, "glass")])
def test_icosphere_box(level, material):
    scene = make_icosphere_box(level, material=material)
    g = scene.geometry
    n_mesh = 20 * 4 ** level
    assert g.num_tris == 12 + n_mesh
    assert not bool(np.asarray(g.sph_valid).any())
    p = np.asarray(g.tri_p)[12:]
    n = np.asarray(g.tri_n)[12:]
    center = np.array([0.0, 0.5, 0.0])
    # vertex normals point away from the mesh centre
    assert (np.sum(n * (p - center), axis=-1) > 0).all()
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
    kinds = np.asarray(scene.materials.kind)[np.asarray(g.tri_mat)[12:]]
    assert len(set(kinds.tolist())) == 1
    # inside the box
    assert p.min() > -1.0 and p[..., 1].max() < 1.5
