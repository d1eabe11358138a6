"""Flatten a parsed COLLADA SceneInfo into device arrays.

Replicates the reference's load-time pipeline (SURVEY.md section 1 data flow
L2 -> L3 -> L4) in one host-side pass:

  - Application::load (application.cpp:228-304): walk nodes, build objects/
    lights in world space, compute the scene bbox, and place the render
    camera from the bbox (centroid target, r = 1.5 * extent/2 * 2, angles
    from the transformed camera view direction).
  - GLScene::Mesh (gl_scene/mesh.cpp:22-43): transform vertices by the node
    transform (projective divide), default 0.5-gray diffuse when no material.
  - Vertex::computeNormal (halfEdgeMesh.h:487-515): area-weighted vertex
    normals summed over adjacent faces.
  - GLScene::Sphere/init_sphere (application.cpp:346-351): world position =
    T*(origin), radius scaled by |T*(1,0,0,0)|.
  - GLScene::AreaLight (gl_scene/area_light.h:15-27): position/direction/
    dim_x/dim_y transformed as points; dim_x = cross(up, direction_local).
  - Camera::configure (camera.cpp:29-47): FOV expanded to match the render
    aspect ratio; Camera::place + compute_position (camera.cpp:53-65,123-147).

Note (documented deviation): the reference converts each halfedge face to a
single triangle from its first three vertices (object.cpp:36-41), silently
dropping quad corners.  All shipped scenes are pure triangle meshes, where
this is identical to our fan triangulation; for polygon faces we emit a full
fan instead of dropping geometry.
"""

from __future__ import annotations

import numpy as np

from bidirectional_pathtracing.scene import collada as C
from bidirectional_pathtracing.scene.types import (
    Camera, Geometry, Lights, Materials, Scene,
    LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE, LIGHT_POINT, LIGHT_SPOT,
    MAT_DIFFUSE,
    make_geometry, make_lights, make_materials,
)


def _xform_point(T: np.ndarray, p: np.ndarray) -> np.ndarray:
    """(T * Vector4D(p,1)).projectTo3D() — homogeneous divide."""
    q = T @ np.append(p, 1.0)
    return q[:3] / q[3]


def _xform_point_nodiv(T: np.ndarray, p: np.ndarray) -> np.ndarray:
    """(T * Vector4D(p,1)).to3D() — no divide (used by light transforms)."""
    q = T @ np.append(p, 1.0)
    return q[:3]


def _vertex_normals(vertices: np.ndarray, polygons) -> np.ndarray:
    """Vertex normals via the faithful halfedge walk (see scene/halfedge.py).

    NOT plain area-weighted winding normals: the reference's boundary-vertex
    walk flips orientation on open meshes (all Cornell-box walls), which the
    one-sided diffuse BSDF depends on.
    """
    from bidirectional_pathtracing.scene.halfedge import (
        compute_vertex_normals)
    return compute_vertex_normals(vertices, polygons)


def _material_record(mat: C.MaterialInfo | None) -> dict:
    if mat is None:
        # gl_scene/mesh.cpp:41 / sphere.cpp:18 default
        return {"kind": MAT_DIFFUSE, "albedo": np.array([0.5, 0.5, 0.5])}
    rec = {"kind": mat.kind}
    rec.update(mat.params)
    return rec


def attach_accelerator(scene, accel: str = "auto",
                       brute_force_max_tris: int = 2048,
                       bvh_max_leaf_size: int = 4):
    """Attach a BVH (escape-link traversal, ops/intersect.py intersect_bvh)
    when the scene has more than brute_force_max_tris prims (accel:
    "auto" | "brute" | "bvh"; RenderConfig.accelerator).  Without one,
    intersection tests every primitive (the Triton kernel on the GPU).
    """
    import numpy as np
    from bidirectional_pathtracing.scene.bvh import build_bvh
    n_prims = (scene.geometry.num_tris + scene.geometry.num_spheres)
    want = accel == "bvh" or (accel == "auto"
                              and n_prims > brute_force_max_tris)
    if not want:
        return scene
    # pull geometry to the host once and hand numpy views to the builder
    g = scene.geometry
    geom_host = g._replace(
        tri_p=np.asarray(g.tri_p, np.float32),
        tri_valid=np.asarray(g.tri_valid),
        sph_c=np.asarray(g.sph_c, np.float32),
        sph_r=np.asarray(g.sph_r, np.float32),
        sph_valid=np.asarray(g.sph_valid))
    if scene.bvh is None:
        scene = scene._replace(
            bvh=build_bvh(geom_host, max_leaf_size=bvh_max_leaf_size))
    return scene


def build_scene(scene_info: C.SceneInfo, screen_w: int, screen_h: int,
                lens_radius: float = 0.0, focal_distance: float = 4.7,
                accel: str = "auto", brute_force_max_tris: int = 2048,
                bvh_max_leaf_size: int = 4, mesh_ops: tuple = (),
                mesh_ops_min_tris: int = 0):
    """Flatten SceneInfo to a Scene pytree (without BVH; attach separately).

    mesh_ops: sequence of "upsample" / "downsample" / "resample" applied to
    every polymesh before triangulation (the reference's EDIT-mode u/d/i
    keys, application.cpp:504-512 — which call unimplemented stubs there).
    mesh_ops_min_tris: only apply mesh_ops to meshes with at least this
    many triangles — e.g. subdivide the statue but not the Cornell-box
    walls, whose open boundaries would shrink under Loop subdivision.

    Returns (scene, aux) where aux carries host-side metadata (names, bbox).
    """
    tri_p, tri_n, tri_mat = [], [], []
    sph_c, sph_r, sph_mat = [], [], []
    materials, mat_keys = [], {}
    lights = []
    cam_info = None
    cam_dir = np.array([0.0, 0.0, -1.0])
    bbox_lo = np.full(3, np.inf)
    bbox_hi = np.full(3, -np.inf)
    names = []

    def add_material(mat: C.MaterialInfo | None) -> int:
        rec = _material_record(mat)
        key = tuple(
            (k, tuple(np.atleast_1d(v).tolist()) if isinstance(v, np.ndarray)
             else v) for k, v in sorted(rec.items(), key=lambda kv: kv[0]))
        if key not in mat_keys:
            mat_keys[key] = len(materials)
            materials.append(rec)
        return mat_keys[key]

    for node in scene_info.nodes:
        T = node.transform
        inst = node.instance
        if isinstance(inst, C.CameraInfo):
            cam_info = inst
            # application.cpp:248-249: view direction transformed AS A POINT
            # (w=1, includes translation) then normalised — reference quirk.
            cam_dir = _xform_point_nodiv(T, inst.view_dir)
            n = np.linalg.norm(cam_dir)
            if n > 0:
                cam_dir = cam_dir / n
        elif isinstance(inst, C.LightInfo):
            lights.append(_build_light(inst, T))
        elif isinstance(inst, C.SphereInfo):
            # application.cpp:346-351 + gl_scene/sphere.cpp:12-20
            pos = _xform_point(T, np.zeros(3))
            scale = np.linalg.norm((T @ np.array([1.0, 0, 0, 0]))[:3])
            r = inst.radius * scale
            sph_c.append(pos)
            sph_r.append(r)
            sph_mat.append(add_material(inst.material))
            bbox_lo = np.minimum(bbox_lo, pos - r)
            bbox_hi = np.maximum(bbox_hi, pos + r)
            names.append(("sphere", node.name))
        elif isinstance(inst, C.PolymeshInfo):
            verts = np.stack([_xform_point(T, v) for v in inst.vertices])
            polygons = inst.polygons
            n_tris0 = sum(max(len(p) - 2, 0) for p in polygons)
            if mesh_ops and n_tris0 >= mesh_ops_min_tris:
                from bidirectional_pathtracing.scene.meshedit import (
                    HalfedgeMesh)
                # The reference's boundary-walk normal flip (see
                # halfedge.py) applies per vertex; subdivision creates
                # interior vertices on open sheets, which would get the
                # opposite (winding) orientation and shade black under the
                # one-sided diffuse BSDF.  Record the original mesh's
                # dominant orientation (reference normals vs winding
                # normals) and orient the edited mesh's winding normals
                # the same way instead.
                ref_n = _vertex_normals(verts, polygons)
                wind_n = _winding_vertex_normals(verts, polygons)
                s = float(np.sign(np.sum(ref_n * wind_n)) or 1.0)
                hm = HalfedgeMesh.build(verts, [list(p) for p in polygons])
                pos, tris = hm.to_arrays()      # triangulate for the ops
                hm = HalfedgeMesh.from_arrays(pos, tris)
                for op in mesh_ops:
                    getattr(hm, op)()
                verts, tris = hm.to_arrays()
                polygons = [list(t) for t in tris]
                normals = s * _winding_vertex_normals(verts, polygons)
            else:
                normals = _vertex_normals(verts, polygons)
            mid = add_material(inst.material)
            for poly in polygons:
                idx = np.asarray(poly)
                for k in range(1, len(idx) - 1):
                    i0, i1, i2 = idx[0], idx[k], idx[k + 1]
                    tri_p.append(verts[[i0, i1, i2]])
                    tri_n.append(normals[[i0, i1, i2]])
                    tri_mat.append(mid)
            bbox_lo = np.minimum(bbox_lo, verts.min(axis=0))
            bbox_hi = np.maximum(bbox_hi, verts.max(axis=0))
            names.append(("mesh", node.name))

    if not materials:
        materials.append({"kind": MAT_DIFFUSE, "albedo": np.array([0.5] * 3)})

    camera, orbit = _place_camera(cam_info, cam_dir, bbox_lo, bbox_hi,
                                  screen_w, screen_h, lens_radius,
                                  focal_distance)

    # keep geometry on the host until the BVH is built — the builder needs
    # the mesh host-side
    geometry = make_geometry(
        np.array(tri_p) if tri_p else np.zeros((0, 3, 3)),
        np.array(tri_n) if tri_n else np.zeros((0, 3, 3)),
        np.array(tri_mat) if tri_mat else np.zeros((0,), np.int32),
        np.array(sph_c) if sph_c else None,
        np.array(sph_r) if sph_r else None,
        np.array(sph_mat) if sph_mat else None,
        to_device=False,
    )
    scene = Scene(
        geometry=geometry,
        materials=make_materials(materials),
        lights=make_lights(lights),
        camera=camera,
    )
    scene = attach_accelerator(scene, accel, brute_force_max_tris,
                               bvh_max_leaf_size)
    import jax.numpy as jnp
    scene = scene._replace(
        geometry=Geometry(*[jnp.asarray(a) for a in scene.geometry]))
    aux = {
        "bbox": (bbox_lo, bbox_hi),
        "names": names,
        "num_tris": len(tri_p),
        "num_spheres": len(sph_c),
        "material_records": materials,
        "orbit": orbit,
    }
    return scene, aux


def _winding_vertex_normals(verts: np.ndarray, polygons) -> np.ndarray:
    """Plain area-weighted winding vertex normals (no boundary flip)."""
    n = np.zeros_like(verts)
    for poly in polygons:
        idx = np.asarray(poly)
        for k in range(1, len(idx) - 1):
            i0, i1, i2 = idx[0], idx[k], idx[k + 1]
            c = np.cross(verts[i1] - verts[i0], verts[i2] - verts[i0])
            n[i0] += c
            n[i1] += c
            n[i2] += c
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _build_light(info: C.LightInfo, T: np.ndarray) -> dict:
    t = info.light_type
    if t == C.LIGHT_AREA:
        # gl_scene/area_light.h:15-27
        position = _xform_point_nodiv(T, info.position)
        direction = _xform_point_nodiv(T, info.direction) - position
        direction /= np.linalg.norm(direction)
        dim_y_local = info.up
        dim_x_local = np.cross(info.up, info.direction)
        dim_x = _xform_point_nodiv(T, dim_x_local) - position
        dim_y = _xform_point_nodiv(T, dim_y_local) - position
        area = np.linalg.norm(dim_x) * np.linalg.norm(dim_y)
        return {"kind": LIGHT_AREA, "radiance": info.spectrum,
                "position": position, "direction": direction,
                "dim_x": dim_x, "dim_y": dim_y, "area": area}
    if t == C.LIGHT_POINT:
        position = _xform_point_nodiv(T, info.position)
        return {"kind": LIGHT_POINT, "radiance": info.spectrum,
                "position": position}
    if t == C.LIGHT_DIRECTIONAL:
        # gl_scene/directional_light.h + DirectionalLight ctor
        # (light.cpp:11-15): dir_to_light = -(-T*dir).unit() — the GL
        # wrapper negates, the static ctor negates again.
        d = -_xform_point_nodiv(T, info.direction)
        d /= np.linalg.norm(d)
        return {"kind": LIGHT_DIRECTIONAL, "radiance": info.spectrum,
                "direction": -d}
    if t == C.LIGHT_AMBIENT:
        return {"kind": LIGHT_HEMISPHERE, "radiance": info.spectrum}
    if t == C.LIGHT_SPOT:
        # gl_scene/spot_light.h:15-22 transforms position/direction; the
        # static SpotLight is an empty stub in the reference
        # (light.cpp:156-194: sample_L returns zero, BDPT methods assert).
        # We keep it in the table so scenes load; it contributes nothing.
        position = _xform_point_nodiv(T, info.position)
        direction = _xform_point_nodiv(T, info.direction) - position
        n = np.linalg.norm(direction)
        if n > 0:
            direction = direction / n
        return {"kind": LIGHT_SPOT, "radiance": info.spectrum,
                "position": position, "direction": direction}
    raise ValueError(f"unsupported light type {t}")


def _place_camera(cam_info, c_dir, bbox_lo, bbox_hi, screen_w, screen_h,
                  lens_radius, focal_distance) -> Camera:
    """Camera::configure + Application::load placement + compute_position."""
    import jax.numpy as jnp

    if cam_info is None:
        cam_info = C.CameraInfo()
    hfov, vfov = cam_info.hfov, cam_info.vfov
    # The reference configures the camera at the Application's default
    # 800x600 window (application.cpp:97, load->init_camera->configure) and
    # only then resizes to the render resolution via set_screen_size
    # (application.cpp:188-191), which recomputes the FOV from the
    # 800x600-derived screenDist (camera.cpp:83-89).  Net effect: the
    # effective FOV depends on the output resolution (narrower for
    # 480x360).  Replicated here for image parity.
    cfg_w, cfg_h = 800, 600
    ar1 = np.tan(np.radians(hfov) / 2) / np.tan(np.radians(vfov) / 2)
    ar = cfg_w / cfg_h
    if ar1 < ar:
        hfov = np.degrees(2 * np.arctan(np.tan(np.radians(vfov) / 2) * ar))
    elif ar1 > ar:
        vfov = np.degrees(2 * np.arctan(np.tan(np.radians(hfov) / 2) / ar))
    screen_dist = cfg_h / (2 * np.tan(np.radians(vfov) / 2))
    if (screen_w, screen_h) != (cfg_w, cfg_h):
        hfov = np.degrees(2 * np.arctan(screen_w / (2 * screen_dist)))
        vfov = np.degrees(2 * np.arctan(screen_h / (2 * screen_dist)))

    if np.all(np.isfinite(bbox_lo)):
        target = (bbox_lo + bbox_hi) / 2
        extent = bbox_hi - bbox_lo
        canonical_view_distance = np.linalg.norm(extent) / 2 * 1.5
        view_distance = canonical_view_distance * 2
        min_r = canonical_view_distance / 10.0
        max_r = canonical_view_distance * 20.0
    else:
        target = np.zeros(3)
        view_distance, min_r, max_r = 1.0, 0.1, 10.0

    phi = np.arccos(np.clip(c_dir[1], -1.0, 1.0))
    theta = np.arctan2(c_dir[0], c_dir[2])
    # place (camera.cpp:53-65): clamp r, nudge phi off the poles
    r = np.clip(view_distance, min_r, max_r)
    if np.sin(phi) == 0:
        phi += 1e-5  # EPS_F
    # compute_position (camera.cpp:123-147)
    sin_phi = np.sin(phi)
    dir_to_camera = np.array([
        r * sin_phi * np.sin(theta),
        r * np.cos(phi),
        r * sin_phi * np.cos(theta),
    ])
    pos = target + dir_to_camera
    up_vec = np.array([0.0, 1.0 if sin_phi > 0 else -1.0, 0.0])
    screen_x = np.cross(up_vec, dir_to_camera)
    screen_x /= np.linalg.norm(screen_x)
    screen_y = np.cross(dir_to_camera, screen_x)
    screen_y /= np.linalg.norm(screen_y)
    c2w = np.stack(
        [screen_x, screen_y, dir_to_camera / np.linalg.norm(dir_to_camera)],
        axis=1)  # columns

    camera = Camera(
        c2w=jnp.asarray(c2w, jnp.float32),
        pos=jnp.asarray(pos, jnp.float32),
        hfov=jnp.asarray(hfov, jnp.float32),
        vfov=jnp.asarray(vfov, jnp.float32),
        nclip=jnp.asarray(cam_info.nclip, jnp.float32),
        fclip=jnp.asarray(cam_info.fclip, jnp.float32),
        lens_radius=jnp.asarray(lens_radius, jnp.float32),
        focal_distance=jnp.asarray(focal_distance, jnp.float32),
    )
    # Orbit state (Camera::place arguments), kept host-side so camera dumps
    # write the true targetPos/phi/theta/r/minR/maxR (camera.cpp:152-170).
    orbit = {"target": target, "phi": float(phi), "theta": float(theta),
             "r": float(r), "min_r": float(min_r), "max_r": float(max_r)}
    return camera, orbit


def load_scene(path: str, width: int, height: int, **kw):
    """Convenience: load + build."""
    info = C.load_dae(path)
    return build_scene(info, width, height, **kw)
