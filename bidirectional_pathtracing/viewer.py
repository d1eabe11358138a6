"""Interactive progressive viewer — the reference GUI, headless.

The reference runs a GLFW window (CGL Viewer) with keyboard-driven render
control (Application::keyboard_event, application.cpp:424-529;
RaytracedRenderer::key_press, raytraced_renderer.cpp:510-589).  The
equivalent here has no GL: the viewer renders progressively (one
camera sample per pixel per tick), keeps the running-mean frame on disk,
and accepts the same keys through a terminal prompt or a localhost HTTP
page (auto-refreshing <img> + key forwarding) — usable over SSH to a GPU
host, which a GLFW window is not.

Key bindings (RENDER mode, matching the reference):
  ] / [      spp x2 / /2 (restarts)           . / ,   max depth +1/-1
  = / -      area-light samples x2 / /2       h       toggle hemisphere NEE
  k / l      lens radius -/+ 0.05             ; / '   focal dist -/+ 0.1
  r          restart render                   s       save image
  d          dump camera settings             C       toggle cell mode
  v          VISUALIZE mode (BVH)             e       EDIT mode (meshes)
  q          quit
VISUALIZE mode: LEFT/RIGHT/UP walk the BVH (type `left`/`right`/`up` at
the prompt or use the arrow keys on the HTTP page), a toggles the ray
overlay, r returns to RENDER mode.
EDIT mode (the reference's mesh-edit keys, application.cpp:504-512 —
whose edit ops are unimplemented stubs there; ours work): u Loop
subdivision, d quadric simplification, i isotropic remeshing, x undo all,
r back to RENDER mode.  Each op rebuilds the scene (scene/meshedit.py)
and restarts the render.  Requires the viewer to be constructed with a
reload_fn (the __main__ entry wires one).
Scene debugger (any mode; the reference's ImGui VisualDebugger): `tree`
lists materials/lights with parameters; `mat <id> <field> <values>` and
`light <id> radiance <r g b>` edit them and restart the render.
"""

from __future__ import annotations

import dataclasses
import io
import sys
import threading
import time
from typing import Optional

import numpy as np

RENDER_MODE = "RENDER"
VISUALIZE_MODE = "VISUALIZE"
EDIT_MODE = "EDIT"


class Viewer:
    """Progressive renderer + reference key dispatch.

    Drive it either with run_terminal()/run_http(), or programmatically:
    tick() renders one pass, key_press(k) applies a key, frame() returns
    the current running-mean HDR frame [H,W,3]."""

    def __init__(self, scene, cfg, output: str = "view.png",
                 scene_name: str = "scene", reload_fn=None):
        from bidirectional_pathtracing.config import RenderConfig
        assert isinstance(cfg, RenderConfig)
        self.scene = scene
        self.cfg = cfg
        self.output = output
        self.scene_name = scene_name
        # EDIT mode: reload_fn(mesh_ops: tuple[str]) -> scene rebuilds the
        # scene with the accumulated edit ops applied to every mesh
        self.reload_fn = reload_fn
        self.mesh_ops: tuple = ()
        self.mode = RENDER_MODE
        self.show_rays = False
        self.render_cell = cfg.cell is not None
        self.passes = 0
        self.messages: list[str] = []
        self._vis = None
        self._lock = threading.Lock()
        self._eye_sum = None
        self._light_sum = None
        self._frame = np.zeros((cfg.height, cfg.width, 3))
        self._quit = False

    # ---- progressive rendering ----
    def restart(self):
        """stop() + start_raytracing() of the reference: clear accumulation."""
        with self._lock:
            self.passes = 0
            self._eye_sum = None
            self._light_sum = None

    def _pass_cfg(self):
        # one sample per pixel per tick; spp=1 makes BDPT splats carry
        # full weight so the running mean is sum/passes
        cell = self.cfg.cell if self.render_cell else None
        return dataclasses.replace(self.cfg, spp=1, cell=cell)

    def tick(self):
        """Render one progressive pass and fold it into the running mean."""
        if self.mode != RENDER_MODE or self.passes >= self.cfg.spp:
            return False
        import jax
        from bidirectional_pathtracing.utils.render import (
            _bdpt_step, _cell_pixel_ids, _pt_step)
        cfg1 = self._pass_cfg()
        w, h = self.cfg.width, self.cfg.height
        key = jax.random.fold_in(jax.random.key(self.cfg.seed), self.passes)
        pix = np.asarray(_cell_pixel_ids(cfg1, w, h))
        if self.cfg.integrator == "bdpt":
            eye_i, light_i, _rays = _bdpt_step(self.scene, key, cfg1, w, h)
            eye_i = np.asarray(eye_i)
            light_i = np.asarray(light_i)
            with self._lock:
                if self._eye_sum is None:
                    self._eye_sum = np.zeros((h * w, 3))
                    self._light_sum = np.zeros((h * w, 3))
                self._eye_sum[pix] += eye_i
                self._light_sum += light_i
                self.passes += 1
                mean = (self._eye_sum + self._light_sum) / self.passes
                self._frame = mean.reshape(h, w, 3)
        else:
            L = np.asarray(_pt_step(self.scene, key, cfg1, w, h)[0])
            with self._lock:
                if self._eye_sum is None:
                    self._eye_sum = np.zeros((h * w, 3))
                self._eye_sum[pix] += L
                self.passes += 1
                full = self._eye_sum / self.passes
                self._frame = full.reshape(h, w, 3)
        return True

    def frame(self) -> np.ndarray:
        with self._lock:
            if self.mode == VISUALIZE_MODE:
                return self._render_visualization()
            return self._frame.copy()

    def frame_png(self) -> bytes:
        """Current frame as PNG bytes (for the HTTP page)."""
        from bidirectional_pathtracing.utils.image import to_color
        from bidirectional_pathtracing.utils.png import write_png
        f = self.frame()
        if self.mode == VISUALIZE_MODE:
            rgb = (np.clip(f, 0, 1) * 255).astype(np.uint8)[::-1]
        else:
            rgb = to_color(f)[::-1]
        buf = io.BytesIO()
        _write_png_bytes(buf, rgb)
        return buf.getvalue()

    def save_image(self):
        from bidirectional_pathtracing.utils import image as img
        img.save_image(self.output, self._frame)
        self._say(f"[PathTracer] Saved to {self.output}")

    # ---- BVH visualization ----
    def _visualizer(self):
        if self._vis is None:
            from bidirectional_pathtracing.utils.bvh_vis import (
                BVHVisualizer)
            self._vis = BVHVisualizer(self.scene)
        return self._vis

    def _render_visualization(self) -> np.ndarray:
        from bidirectional_pathtracing.utils.bvh_vis import (
            collect_ray_log)
        w, h = self.cfg.width, self.cfg.height
        log = (collect_ray_log(self.scene, w, h, 500)
               if self.show_rays else None)
        return self._visualizer().render(w, h, ray_log=log, ray_stride=1)

    # ---- key dispatch (application.cpp:424-529 RENDER/VISUALIZE modes) ----
    def key_press(self, key: str) -> bool:
        """Apply a key.  Returns False when the viewer should quit."""
        if key == "q":
            self._quit = True
            return False
        if key.split() and key.split()[0] in ("tree", "mat", "light"):
            self._debugger_command(key.split())
            return True
        if self.mode == RENDER_MODE:
            return self._key_render_mode(key)
        if self.mode == EDIT_MODE:
            return self._key_edit_mode(key)
        return self._key_visualize_mode(key)

    # ---- scene debugger (the reference's ImGui VisualDebugger tree of
    # lights/objects with per-BSDF parameter editors, visual_debugger.cpp,
    # DragDouble* used from bsdf.cpp:87-94 — headless command form) ----
    _MAT_FIELDS = {"albedo": 3, "emission": 3, "reflectance": 3,
                   "transmittance": 3, "ior": 1, "roughness": 1}
    _MAT_KINDS = ["diffuse", "emission", "mirror", "refraction", "glass",
                  "microfacet"]

    def _debugger_command(self, parts):
        import numpy as np
        m = self.scene.materials
        li = self.scene.lights
        if parts[0] == "tree":
            self._say(f"[Debugger] scene '{self.scene_name}'")
            for i in range(m.kind.shape[0]):
                kind = self._MAT_KINDS[int(m.kind[i])]
                alb = np.asarray(m.albedo[i]).round(3).tolist()
                emi = np.asarray(m.emission[i]).round(3).tolist()
                self._say(f"  mat {i}: {kind} albedo={alb} emission={emi} "
                          f"ior={float(m.ior[i]):.3g} "
                          f"roughness={float(m.roughness[i]):.3g}")
            for i in range(li.kind.shape[0]):
                rad = np.asarray(li.radiance[i]).round(3).tolist()
                self._say(f"  light {i}: kind={int(li.kind[i])} "
                          f"radiance={rad}")
            self._say("[Debugger] edit: mat <id> <field> <values> | "
                      "light <id> radiance <r g b>")
            return
        try:
            idx = int(parts[1])
            field = parts[2]
            vals = [float(v) for v in parts[3:]]
            if parts[0] == "mat":
                width = self._MAT_FIELDS[field]
                assert len(vals) == width, f"{field} takes {width} values"
                arr = getattr(m, field)
                new = arr.at[idx].set(vals if width > 1 else vals[0])
                self.scene = self.scene._replace(
                    materials=m._replace(**{field: new}))
            else:
                assert field == "radiance" and len(vals) == 3
                self.scene = self.scene._replace(
                    lights=li._replace(radiance=li.radiance.at[idx].set(vals)))
            self.restart()
            self._say(f"[Debugger] {parts[0]} {idx} {field} <- {vals}; "
                      "render restarted")
        except Exception as e:
            self._say(f"[Debugger] bad command {' '.join(parts)!r}: {e}")

    def _key_render_mode(self, key: str) -> bool:
        if key in ("v", "V"):
            self.mode = VISUALIZE_MODE
            self._say("[Viewer] VISUALIZE mode (BVH)")
        elif key in ("e", "E"):
            if self.reload_fn is None:
                self._say("[Viewer] EDIT mode needs a reload_fn "
                          "(run via python -m ...viewer)")
            else:
                self.mode = EDIT_MODE
                self._say("[Viewer] EDIT mode: u=upsample d=downsample "
                          "i=resample x=undo-all r=render")
        elif key in ("s", "S"):
            self.save_image()
        elif key in ("r", "R"):
            self.restart()
            self._say("[Viewer] restarted render")
        elif key in ("d", "D"):
            from bidirectional_pathtracing.scene.camera_file import (
                dump_camera_settings)
            path = f"{self.scene_name}_cam_settings.txt"
            dump_camera_settings(self.scene.camera, path,
                                 self.cfg.width, self.cfg.height)
            self._say(f"[Camera] Dumped settings to {path}")
        elif key == "C":
            self.render_cell = not self.render_cell
            self._say("[PathTracer] Now in cell render mode."
                      if self.render_cell else
                      "[PathTracer] No longer in cell render mode.")
            self.restart()
        else:
            changed = self._param_key(key)
            if changed:
                self.restart()
        return True

    def _key_edit_mode(self, key: str) -> bool:
        """EDIT mode: interactive mesh ops (the reference's u/d/i keys,
        application.cpp:504-512, which call unimplemented stubs there)."""
        ops = {"u": "upsample", "d": "downsample", "i": "resample"}
        if key in ("r", "R"):
            self.mode = RENDER_MODE
            self.restart()
            self._say("[Viewer] RENDER mode")
        elif key in ("x", "X"):
            self.mesh_ops = ()
            self._reload("[MeshEdit] reverted all edits")
        elif key.lower() in ops:
            self.mesh_ops = self.mesh_ops + (ops[key.lower()],)
            self._reload(f"[MeshEdit] applied {ops[key.lower()]} "
                         f"(ops: {', '.join(self.mesh_ops) or 'none'})")
        return True

    def _reload(self, msg: str):
        try:
            new_scene = self.reload_fn(self.mesh_ops)
        except Exception as e:
            self._say(f"[MeshEdit] edit failed: {e}")
            return
        with self._lock:
            self.scene = new_scene
            self._vis = None
        self.restart()
        self._say(msg)

    def _key_visualize_mode(self, key: str) -> bool:
        vis = self._visualizer()
        if key in ("r", "R"):
            self.mode = RENDER_MODE
            self.restart()
            self._say("[Viewer] RENDER mode")
        elif key in ("UP", "up"):
            vis.up()
        elif key in ("LEFT", "left"):
            vis.to_left()
        elif key in ("RIGHT", "right"):
            vis.to_right()
        elif key in ("a", "A"):
            self.show_rays = not self.show_rays
        else:
            self._param_key(key)
        return True

    def _param_key(self, key: str) -> bool:
        """RaytracedRenderer::key_press (raytraced_renderer.cpp:510-589).
        Returns True if a parameter changed (caller restarts the render)."""
        c = self.cfg
        r = dataclasses.replace
        if key == "]":
            self.cfg = r(c, spp=c.spp * 2)
            self._say(f"[PathTracer] Samples per pixel changed to "
                      f"{self.cfg.spp}")
        elif key == "[":
            self.cfg = r(c, spp=max(c.spp // 2, 1))
            self._say(f"[PathTracer] Samples per pixel changed to "
                      f"{self.cfg.spp}")
        elif key in ("=", "+"):
            self.cfg = r(c, light_samples=c.light_samples * 2)
            self._say(f"[PathTracer] Area light sample count increased to "
                      f"{self.cfg.light_samples}.")
        elif key in ("-", "_"):
            self.cfg = r(c, light_samples=max(c.light_samples // 2, 1))
            self._say(f"[PathTracer] Area light sample count decreased to "
                      f"{self.cfg.light_samples}.")
        elif key in (".", ">"):
            self.cfg = r(c, max_ray_depth=c.max_ray_depth + 1)
            self._say(f"[PathTracer] Max ray depth increased to "
                      f"{self.cfg.max_ray_depth}.")
        elif key in (",", "<"):
            self.cfg = r(c, max_ray_depth=max(c.max_ray_depth - 1, 0))
            self._say(f"[PathTracer] Max ray depth decreased to "
                      f"{self.cfg.max_ray_depth}.")
        elif key in ("h", "H"):
            self.cfg = r(c, direct_hemisphere_sample=
                         not c.direct_hemisphere_sample)
            self._say("[PathTracer] Toggled direct lighting to %s" % (
                "uniform hemisphere sampling"
                if self.cfg.direct_hemisphere_sample
                else "importance light sampling"))
        elif key in ("k", "K", "l", "L", ";", "'"):
            import jax.numpy as jnp
            cam = self.scene.camera
            lr = float(cam.lens_radius)
            fd = float(cam.focal_distance)
            if key in ("k", "K"):
                lr = max(lr - 0.05, 0.0)
                self._say(f"[PathTracer] Camera lens radius reduced to "
                          f"{lr:f}.")
            elif key in ("l", "L"):
                lr = lr + 0.05
                self._say(f"[PathTracer] Camera lens radius increased to "
                          f"{lr:f}.")
            elif key == ";":
                fd = max(fd - 0.1, 0.0)
                self._say(f"[PathTracer] Camera focal distance reduced to "
                          f"{fd:f}.")
            else:
                fd = fd + 0.1
                self._say(f"[PathTracer] Camera focal distance increased "
                          f"to {fd:f}.")
            self.scene = self.scene._replace(camera=cam._replace(
                lens_radius=jnp.float32(lr), focal_distance=jnp.float32(fd)))
            self.cfg = r(c, lens_radius=lr, focal_distance=fd)
        else:
            return False
        return True

    def _say(self, msg: str):
        self.messages.append(msg)
        print(msg, file=sys.stderr)

    # ---- front-ends ----
    def run_terminal(self, max_passes: Optional[int] = None):
        """Render progressively; poll stdin for keys between passes."""
        import select
        n = 0
        while not self._quit:
            progressed = self.tick()
            n += 1 if progressed else 0
            if max_passes is not None and n >= max_passes:
                break
            if not progressed:
                time.sleep(0.1)
            self._write_frame()
            while select.select([sys.stdin], [], [], 0)[0]:
                line = sys.stdin.readline()
                if not line:
                    self._quit = True
                    break
                k = line.strip()
                if k and not self.key_press(k):
                    break
        self._write_frame()

    def _write_frame(self):
        with open(self.output, "wb") as f:
            f.write(self.frame_png())

    def run_http(self, port: int = 8265, max_passes: Optional[int] = None,
                 open_msg: bool = True):
        """Serve the progressive render at http://localhost:<port>/ with
        key forwarding; blocks rendering in the current thread."""
        server = _make_server(self, port)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        if open_msg:
            self._say(f"[Viewer] serving on http://localhost:{port}/ "
                      f"(keys are forwarded; q quits)")
        n = 0
        try:
            while not self._quit:
                progressed = self.tick()
                n += 1 if progressed else 0
                if max_passes is not None and n >= max_passes:
                    break
                if not progressed:
                    time.sleep(0.1)
        finally:
            self._write_frame()
            server.shutdown()


_PAGE = """<!doctype html><html><head><title>bdpt viewer</title>
<style>body{background:#111;color:#ddd;font-family:monospace}
img{image-rendering:pixelated;border:1px solid #444}</style></head>
<body><h3>bdpt viewer</h3>
<div id=s></div><img id=v width=%WIDTH% src="/frame.png">
<p>keys: ] [ = - . , h k l ; ' r s d C v q &middot; arrows walk the BVH in
visualize mode</p>
<script>
setInterval(()=>{document.getElementById('v').src='/frame.png?'+Date.now();
fetch('/status').then(r=>r.json()).then(j=>{
document.getElementById('s').textContent=
`mode=${j.mode} pass ${j.passes}/${j.spp} ${j.last||''}`;});},1000);
document.addEventListener('keydown',e=>{
const m={ArrowUp:'UP',ArrowLeft:'LEFT',ArrowRight:'RIGHT'};
fetch('/key?k='+encodeURIComponent(m[e.key]||e.key));});
</script></body></html>"""


def _make_server(viewer: Viewer, port: int):
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                page = _PAGE.replace("%WIDTH%",
                                     str(viewer.cfg.width * 2))
                self._send(200, "text/html", page.encode())
            elif u.path == "/frame.png":
                self._send(200, "image/png", viewer.frame_png())
            elif u.path == "/status":
                st = {"mode": viewer.mode, "passes": viewer.passes,
                      "spp": viewer.cfg.spp,
                      "last": viewer.messages[-1] if viewer.messages
                      else ""}
                self._send(200, "application/json",
                           json.dumps(st).encode())
            elif u.path == "/key":
                k = parse_qs(u.query).get("k", [""])[0]
                if k:
                    viewer.key_press(k)
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def _write_png_bytes(buf, rgb: np.ndarray):
    """write_png into a buffer (utils.png writes to a path)."""
    import struct
    import zlib

    from bidirectional_pathtracing.utils.png import _chunk
    h, w = rgb.shape[:2]
    if rgb.shape[2] == 3:
        rgba = np.concatenate(
            [rgb, np.full((h, w, 1), 255, np.uint8)], axis=2)
    else:
        rgba = rgb
    raw = b"".join(b"\x00" + rgba[i].tobytes() for i in range(h))
    buf.write(b"\x89PNG\r\n\x1a\n")
    buf.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
    buf.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
    buf.write(_chunk(b"IEND", b""))


def main(argv=None):
    """python -m bidirectional_pathtracing.viewer [cli flags] scene.dae
    [--http PORT | --terminal]"""
    import argparse

    from bidirectional_pathtracing.cli import build_argparser

    ap = build_argparser()
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="serve the progressive render over HTTP")
    ap.add_argument("--max-passes", type=int, default=None)
    args = ap.parse_args(argv)

    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.build import load_scene

    w, h = args.size
    cfg = RenderConfig(
        spp=args.spp, light_samples=args.light_samples,
        max_ray_depth=args.max_depth, width=w, height=h,
        integrator=args.integrator,
        direct_hemisphere_sample=args.hemisphere,
        lens_radius=args.lens_radius, focal_distance=args.focal_distance,
        seed=args.seed, cell=tuple(args.cell) if args.cell else None,
    )
    scene, aux = load_scene(args.scene, w, h, lens_radius=cfg.lens_radius,
                            focal_distance=cfg.focal_distance)
    if args.envmap:
        from bidirectional_pathtracing.ops import envlight
        from bidirectional_pathtracing.utils.exr import read_exr
        scene = scene._replace(
            envmap=envlight.build_envmap(read_exr(args.envmap)))
    name = args.scene.rsplit("/", 1)[-1].rsplit(".", 1)[0]

    def reload_fn(mesh_ops):
        s2, _ = load_scene(args.scene, w, h, lens_radius=cfg.lens_radius,
                           focal_distance=cfg.focal_distance,
                           mesh_ops=tuple(mesh_ops))
        if scene.envmap is not None:
            s2 = s2._replace(envmap=scene.envmap)
        return s2

    viewer = Viewer(scene, cfg, output=args.output, scene_name=name,
                    reload_fn=reload_fn)
    if args.http:
        viewer.run_http(args.http, max_passes=args.max_passes)
    else:
        viewer.run_terminal(max_passes=args.max_passes)


if __name__ == "__main__":
    main()
