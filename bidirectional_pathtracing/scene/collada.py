"""COLLADA (.dae) scene loader.

Host-side Python replacement for the reference parser
(reference: src/scene/collada/collada.cpp) with identical semantics:

  - up-axis correction matrix (collada.cpp:164-203): X_UP swaps x/y and
    negates z; Z_UP swaps y/z and negates x; Y_UP is identity.
  - node transform accumulation (collada.cpp:247-340): a <matrix> element
    wins outright (and stops scanning further transform elements, matching
    the reference's `break`); otherwise rotate/translate/scale elements
    each PRE-multiply the accumulated local transform.  The parent's
    accumulated transform pre-multiplies the node's local transform.
  - camera (collada.cpp:434-475): xfov else 50, yfov else derived from
    aspect_ratio; view_dir (0,0,-1); znear/zfar.
  - lights (collada.cpp:477-580): CGL profile technique preferred over
    common; area lights come from the CGL <area> extension.
  - geometry: <mesh> polymeshes (sources/vertices/polylist,
    collada.cpp:606-829) and CGL <sphere> extension (collada.cpp:580-604).
  - materials (collada.cpp:854-936): CGL technique tags
    emission/mirror/microfacet/refraction/glass, else phong diffuse color,
    else 0.5 gray diffuse.

Output is a list of `Node(transform, instance)` records mirroring
Collada::SceneInfo; scene/build.py flattens them to device arrays.
"""

from __future__ import annotations

import dataclasses
import re
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from bidirectional_pathtracing.scene.types import (
    MAT_DIFFUSE, MAT_EMISSION, MAT_GLASS, MAT_MICROFACET, MAT_MIRROR,
    MAT_REFRACTION,
)

LIGHT_NONE = "none"
LIGHT_AMBIENT = "ambient"
LIGHT_DIRECTIONAL = "directional"
LIGHT_AREA = "area"
LIGHT_POINT = "point"
LIGHT_SPOT = "spot"


@dataclasses.dataclass
class CameraInfo:
    hfov: float = 50.0
    vfov: float = 35.0
    nclip: float = 0.001
    fclip: float = 1000.0
    view_dir: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up_dir: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))


@dataclasses.dataclass
class LightInfo:
    light_type: str = LIGHT_NONE
    spectrum: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3))
    # COLLADA / CGL defaults (light_info.cpp:7-19)
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    constant_att: float = 1.0
    linear_att: float = 0.0
    quadratic_att: float = 0.0


@dataclasses.dataclass
class MaterialInfo:
    kind: int = MAT_DIFFUSE
    params: dict = dataclasses.field(default_factory=dict)
    name: str = ""


@dataclasses.dataclass
class PolymeshInfo:
    vertices: np.ndarray = None          # [V,3] float64
    polygons: list = None                # list of index lists
    material: Optional[MaterialInfo] = None
    name: str = ""


@dataclasses.dataclass
class SphereInfo:
    radius: float = 1.0
    material: Optional[MaterialInfo] = None
    name: str = ""


@dataclasses.dataclass
class Node:
    transform: np.ndarray                # [4,4] float64 (includes up-axis fix)
    instance: object                     # CameraInfo | LightInfo | PolymeshInfo | SphereInfo
    name: str = ""


@dataclasses.dataclass
class SceneInfo:
    nodes: list


_TAG_NS = re.compile(r"\{.*\}")


def _strip_ns(tree: ET.Element):
    for el in tree.iter():
        el.tag = _TAG_NS.sub("", el.tag)
    return tree


def _floats(text: str) -> np.ndarray:
    return np.fromstring(text, sep=" ") if False else np.array(
        [float(x) for x in text.split()], dtype=np.float64)


def _spectrum(text: str) -> np.ndarray:
    """spectrum_from_string: first three floats."""
    return _floats(text)[:3]


def _find(el, path):
    return el.find(path) if el is not None else None


def _technique_common(el):
    return _find(el, "technique_common")


def _technique_cgl(el):
    """CGL extension profile: <extra><technique profile="CGL">."""
    extra = _find(el, "extra")
    if extra is None:
        return None
    for tech in extra.findall("technique"):
        if tech.get("profile") in ("CGL", "462", "CMU462", "CS184"):
            return tech
    return None


def _up_axis_transform(root):
    """collada.cpp:164-203."""
    transform = np.eye(4)
    up = np.array([0.0, 1.0, 0.0])
    asset = root.find("asset")
    if asset is not None:
        up_el = asset.find("up_axis")
        up_dir = up_el.text.strip() if up_el is not None and up_el.text else "Y_UP"
        if up_dir == "X_UP":
            transform = np.eye(4)
            transform[0, 0] = 0.0
            transform[0, 1] = 1.0
            transform[1, 0] = 1.0
            transform[1, 1] = 0.0
            transform[2, 2] = -1.0
            up = np.array([1.0, 0.0, 0.0])
        elif up_dir == "Z_UP":
            transform = np.eye(4)
            transform[1, 1] = 0.0
            transform[1, 2] = 1.0
            transform[2, 1] = 1.0
            transform[2, 2] = 0.0
            transform[0, 0] = -1.0
            up = np.array([0.0, 0.0, 1.0])
    return transform, up


class _Parser:
    def __init__(self, root: ET.Element):
        self.root = root
        self.uri = {}
        for el in root.iter():
            i = el.get("id")
            if i is not None:
                self.uri[i] = el
        self.transform, self.up = _up_axis_transform(root)
        self.nodes = []

    # -- node walk ---------------------------------------------------------

    def parse_node(self, xml: ET.Element, parent_transform: np.ndarray):
        local = np.eye(4)
        for e in xml:
            tag = e.tag
            if tag == "matrix":
                # Short matrices are zero-padded: the reference streams 16
                # values into a zero-initialised Matrix4x4, so failed reads
                # stay 0 (CBgems.dae ships a 15-value camera matrix).
                vals = _floats(e.text)
                if vals.size < 16:
                    vals = np.concatenate([vals, np.zeros(16 - vals.size)])
                local = vals[:16].reshape(4, 4)
                break  # reference collada.cpp:268: matrix wins, stop scanning
            if tag == "rotate":
                # Reference quirk (collada.cpp:272-299): reads the first 4
                # numbers of the rotate element into fixed matrix slots
                # selected by the sid's last character.  Kept for parity;
                # Blender exports use <matrix> so this path is rarely hit.
                m = np.eye(4)
                vals = _floats(e.text)
                sid = e.get("sid", " ")
                axis = sid[-1] if sid else " "
                v = list(vals) + [0.0] * 4
                if axis == "X":
                    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = v[0], v[1], v[2], v[3]
                elif axis == "Y":
                    m[0, 0], m[2, 0], m[0, 2], m[2, 2] = v[0], v[1], v[2], v[3]
                elif axis == "Z":
                    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = v[0], v[1], v[2], v[3]
                local = m @ local
            if tag == "translate":
                m = np.eye(4)
                vals = _floats(e.text)
                m[0, 3], m[1, 3], m[2, 3] = vals[0], vals[1], vals[2]
                local = m @ local
            if tag == "scale":
                # Reference quirk (collada.cpp:318-320): reads into
                # m(0,0), m(1,1), m(1,1) — the z scale is dropped and the
                # y slot is read twice.  Kept for parity.
                m = np.eye(4)
                vals = _floats(e.text)
                m[0, 0] = vals[0]
                m[1, 1] = vals[2] if len(vals) > 2 else vals[-1]
                local = m @ local

        total = parent_transform @ local

        for child in xml.findall("node"):
            self.parse_node(child, total)

        instance = None
        name = xml.get("name", "")
        e_camera = xml.find("instance_camera")
        e_light = xml.find("instance_light")
        e_geometry = xml.find("instance_geometry")
        if e_camera is not None:
            instance = self.parse_camera(self.uri_find(e_camera.get("url")))
        elif e_light is not None:
            instance = self.parse_light(self.uri_find(e_light.get("url")))
        elif e_geometry is not None:
            geo = self.uri_find(e_geometry.get("url"))
            material = None
            e_mat = _find(xml, "instance_geometry/bind_material/"
                               "technique_common/instance_material")
            if e_mat is not None:
                material = self.parse_material(self.uri_find(e_mat.get("target")))
            if geo is not None and geo.find("mesh") is not None:
                instance = self.parse_polymesh(geo)
                instance.material = material
            elif geo is not None and geo.find("extra") is not None:
                instance = self.parse_sphere(geo)
                instance.material = material
        if instance is not None:
            self.nodes.append(Node(transform=total, instance=instance, name=name))

    def uri_find(self, url):
        if url is None:
            return None
        return self.uri.get(url.lstrip("#"))

    # -- instances ---------------------------------------------------------

    def parse_camera(self, xml) -> CameraInfo:
        cam = CameraInfo(up_dir=self.up.copy())
        persp = _find(xml, "optics/technique_common/perspective")
        if persp is None:
            raise ValueError("no perspective defined in camera")
        xfov = persp.find("xfov")
        yfov = persp.find("yfov")
        znear = persp.find("znear")
        zfar = persp.find("zfar")
        cam.hfov = float(xfov.text) if xfov is not None else 50.0
        cam.vfov = float(yfov.text) if yfov is not None else 35.0
        cam.nclip = float(znear.text) if znear is not None else 0.001
        cam.fclip = float(zfar.text) if zfar is not None else 1000.0
        if yfov is None:
            ar_el = persp.find("aspect_ratio")
            if ar_el is None:
                raise ValueError("incomplete perspective definition")
            ar = float(ar_el.text)
            cam.vfov = np.degrees(
                2 * np.arctan(np.tan(np.radians(0.5 * cam.hfov)) / ar))
        return cam

    def parse_light(self, xml) -> LightInfo:
        light = LightInfo()
        tech = _technique_cgl(xml)
        if tech is None:
            tech = _technique_common(xml)
        if tech is None:
            raise ValueError("no supported profile in light")
        e = next(iter(tech), None)
        if e is None:
            return light
        ltype = e.tag
        color = _find(e, "color")
        if color is not None:
            light.spectrum = _spectrum(color.text)
        if ltype in (LIGHT_AMBIENT, LIGHT_DIRECTIONAL, LIGHT_AREA,
                     LIGHT_POINT, LIGHT_SPOT):
            light.light_type = ltype
        else:
            raise ValueError(f"unsupported light type {ltype}")
        return light

    def parse_material(self, xml) -> Optional[MaterialInfo]:
        if xml is None:
            return None
        mat = MaterialInfo(name=xml.get("name", ""))
        e_effect = xml.find("instance_effect")
        if e_effect is None:
            raise ValueError("no target effects found for material")
        effect = self.uri_find(e_effect.get("url"))
        tech_common = _find(effect, "profile_COMMON/technique")
        tech_cgl = _technique_cgl(effect)
        if tech_cgl is not None:
            for e in tech_cgl:
                t = e.tag
                if t == "emission":
                    mat.kind = MAT_EMISSION
                    mat.params["emission"] = _spectrum(_find(e, "radiance").text)
                elif t == "mirror":
                    mat.kind = MAT_MIRROR
                    mat.params["reflectance"] = _spectrum(
                        _find(e, "reflectance").text)
                elif t == "microfacet":
                    mat.kind = MAT_MICROFACET
                    mat.params["roughness"] = float(_find(e, "alpha").text)
                    mat.params["eta"] = _spectrum(_find(e, "eta").text)
                    mat.params["k"] = _spectrum(_find(e, "k").text)
                elif t == "refraction":
                    mat.kind = MAT_REFRACTION
                    mat.params["transmittance"] = _spectrum(
                        _find(e, "transmittance").text)
                    mat.params["ior"] = float(_find(e, "ior").text)
                elif t == "glass":
                    mat.kind = MAT_GLASS
                    mat.params["transmittance"] = _spectrum(
                        _find(e, "transmittance").text)
                    mat.params["reflectance"] = _spectrum(
                        _find(e, "reflectance").text)
                    mat.params["ior"] = float(_find(e, "ior").text)
        elif tech_common is not None:
            diffuse = _find(tech_common, "phong/diffuse/color")
            if diffuse is not None:
                mat.params["albedo"] = _spectrum(diffuse.text)
            else:
                mat.params["albedo"] = np.array([0.5, 0.5, 0.5])
        else:
            mat.params["albedo"] = np.array([0.5, 0.5, 0.5])
        return mat

    def parse_polymesh(self, xml) -> PolymeshInfo:
        mesh = PolymeshInfo(name=xml.get("name", ""))
        e_mesh = xml.find("mesh")
        sources = {}
        for src in e_mesh.findall("source"):
            fa = src.find("float_array")
            if fa is not None:
                n = int(fa.get("count"))
                sources[src.get("id")] = _floats(fa.text)[:n]
        e_vertices = e_mesh.find("vertices")
        vertices_id = e_vertices.get("id")
        vertices = None
        for inp in e_vertices.findall("input"):
            if inp.get("semantic") == "POSITION":
                floats = sources[inp.get("source").lstrip("#")]
                vertices = floats.reshape(-1, 3)
        mesh.vertices = vertices

        polygons = []
        for list_tag in ("polylist", "triangles"):
            for e_poly in e_mesh.findall(list_tag):
                stride = 0
                vertex_offset = 0
                has_vertex = False
                for inp in e_poly.findall("input"):
                    sem = inp.get("semantic")
                    off = int(inp.get("offset", 0))
                    stride = max(stride, off + 1)
                    if sem == "VERTEX":
                        has_vertex = True
                        vertex_offset = off
                        if inp.get("source").lstrip("#") != vertices_id:
                            raise ValueError("VERTEX source mismatch")
                count = int(e_poly.get("count"))
                if list_tag == "triangles":
                    sizes = [3] * count
                else:
                    sizes = [int(x) for x in e_poly.find("vcount").text.split()]
                p = np.array([int(x) for x in e_poly.find("p").text.split()],
                             dtype=np.int64)
                if has_vertex:
                    k = 0
                    for sz in sizes:
                        idx = p[(k + np.arange(sz)) * stride + vertex_offset]
                        polygons.append(idx)
                        k += sz
        mesh.polygons = polygons
        return mesh

    def parse_sphere(self, xml) -> SphereInfo:
        tech = _technique_cgl(xml)
        if tech is None:
            raise ValueError("no CGL profile technique in sphere geometry")
        radius = _find(tech, "sphere/radius")
        return SphereInfo(radius=float(radius.text), name=xml.get("name", ""))


def load_dae(path: str) -> SceneInfo:
    """Parse a .dae file into a SceneInfo (node list with world transforms)."""
    tree = ET.parse(path)
    root = _strip_ns(tree.getroot())
    if root.tag != "COLLADA":
        raise ValueError(f"{path} is not a COLLADA file")
    parser = _Parser(root)
    scene = _find(root, "scene/instance_visual_scene")
    if scene is None:
        raise ValueError("no scene description found")
    vs = parser.uri_find(scene.get("url"))
    if vs is None:
        raise ValueError("visual scene not found")
    for node in vs.findall("node"):
        parser.parse_node(node, parser.transform)
    return SceneInfo(nodes=parser.nodes)
