"""Replay exact reference BDPT paths through our connection/MIS code.

Fixtures pd_*.txt were produced by an instrumented headless build of the
reference integrator: for one camera sample it dumps both subpaths (the
exact positions/normals/alphas/pdfs the reference computed), the fresh
light samples drawn for t=1 connections, and the per-(s,t) connection
results (c, contrib, MIS weight w, ill).  We rebuild the same subpaths as
Subpath arrays, inject the same fresh samples, and check our
_estimate_radiance/_mis_weight reproduce the reference values — this pins
the BDPT math (including all s/t edge cases and the delta rules) without
any Monte Carlo noise.
"""

import glob
import os

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not reference_available(),
                                reason="reference scenes not mounted")]

import jax.numpy as jnp  # noqa: E402

SCENE_FOR_PREFIX = {
    "pd_cbl": f"{REFERENCE}/dae/sky/CBspheres_lambertian.dae",
    "pd_cbs": f"{REFERENCE}/dae/sky/CBspheres.dae",
}
MAX_DEPTH = 5
W, H = 120, 90


def _parse_dump(path):
    eye, light, ls, es, est = {}, {}, {}, {}, {}
    for line in open(path):
        t = line.split()
        assert t[0] == "PD"
        if t[1] in ("EYE", "LIGHT"):
            k = int(t[2])
            rec = dict(
                pos=[float(x) for x in t[4:7]],
                n=[float(x) for x in t[8:11]],
                alpha=[float(x) for x in t[12:15]],
                p=float(t[16]), dir_pdf=float(t[18]),
                alb=float(t[20]), delta=int(t[22]), mat=int(t[24]))
            (eye if t[1] == "EYE" else light)[k] = rec
        elif t[1] in ("LS", "ES"):
            key = (int(t[2]), int(t[3]))
            rec = dict(pos=[float(x) for x in t[5:8]],
                       n=[float(x) for x in t[9:12]],
                       alpha=[float(x) for x in t[13:16]],
                       p=float(t[17]), dir_pdf=float(t[19]))
            (ls if t[1] == "LS" else es)[key] = rec
        elif t[1] == "EST":
            key = (int(t[2]), int(t[3]))
            est[key] = dict(c=[float(x) for x in t[5:8]],
                            contrib=[float(x) for x in t[9:12]],
                            w=float(t[13]),
                            ill=[float(x) for x in t[15:18]],
                            xy=(int(t[19]), int(t[20])))
    return eye, light, ls, es, est


def _build_subpath(verts, nv, dump_mat_to_mine):
    from bidirectional_pathtracing.models.bdpt import Subpath
    pos = np.zeros((1, nv + 2, 3), np.float32)
    n = np.zeros((1, nv + 2, 3), np.float32)
    alpha = np.zeros((1, nv + 2, 3), np.float32)
    p = np.zeros((1, nv + 2), np.float32)
    mat = np.full((1, nv + 2), -1, np.int32)
    valid = np.zeros((1, nv + 2), bool)
    dir_pdf = np.zeros((1,), np.float32)
    for k, rec in verts.items():
        pos[0, k] = rec["pos"]
        n[0, k] = rec["n"]
        alpha[0, k] = rec["alpha"]
        p[0, k] = rec["p"]
        mat[0, k] = dump_mat_to_mine.get(rec["mat"], -1)
        valid[0, k] = True
        if k == 1:
            dir_pdf[0] = rec["dir_pdf"]
    return Subpath(pos=jnp.asarray(pos), n=jnp.asarray(n),
                   alpha=jnp.asarray(alpha), p=jnp.asarray(p),
                   mat=jnp.asarray(mat), valid=jnp.asarray(valid),
                   dir_pdf=jnp.asarray(dir_pdf))


def _dump_material_map(scene_dae, aux):
    """Map harness material indices (scene-dump order, no dedup) to our
    deduped material-table ids by re-running the dump-order walk."""
    from bidirectional_pathtracing.scene import collada as C
    from bidirectional_pathtracing.scene.build import _material_record
    info = C.load_dae(scene_dae)
    records = aux["material_records"]

    def rec_key(rec):
        return tuple(
            (k, tuple(np.atleast_1d(v).tolist()) if isinstance(v, np.ndarray)
             else v) for k, v in sorted(rec.items(), key=lambda kv: kv[0]))

    mine_by_key = {rec_key(r): i for i, r in enumerate(records)}
    mapping = {}
    di = 0
    for node in info.nodes:
        inst = node.instance
        if isinstance(inst, (C.SphereInfo, C.PolymeshInfo)):
            rec = _material_record(inst.material)
            mapping[di] = mine_by_key[rec_key(rec)]
            di += 1
    return mapping


@pytest.mark.parametrize("dump_path", sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "golden", "pd_*.txt"))))
def test_replay_reference_paths(dump_path):
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.models import bdpt
    from bidirectional_pathtracing.scene.build import load_scene

    prefix = os.path.basename(dump_path).rsplit("_", 1)[0]
    scene_dae = SCENE_FOR_PREFIX[prefix]
    scene, aux = load_scene(scene_dae, W, H)
    # bdpt_reference_t1_mis: the dumps record the reference's t=1 MIS
    # junction defect (see models/bdpt.py _mis_weight docstring); replay
    # must reproduce it to pin the rest of the math
    cfg = RenderConfig(spp=1, max_ray_depth=MAX_DEPTH, width=W, height=H,
                       integrator="bdpt", bdpt_reference_t1_mis=True)
    eye_d, light_d, ls_d, es_d, est_d = _parse_dump(dump_path)
    m = _dump_material_map(scene_dae, aux)
    nv = MAX_DEPTH + 1
    eye = _build_subpath(eye_d, nv, m)
    light = _build_subpath(light_d, nv, m)

    import jax
    checked = 0
    for (i_eye, i_light), ref in sorted(est_d.items()):
        inject = {}
        if (i_eye, i_light) in ls_d:
            r = ls_d[(i_eye, i_light)]
            inject["light_sample"] = dict(
                pos=jnp.asarray([r["pos"]], jnp.float32),
                n=jnp.asarray([r["n"]], jnp.float32),
                alpha=jnp.asarray([r["alpha"]], jnp.float32),
                p=jnp.asarray([r["p"]], jnp.float32),
                mat=jnp.asarray([-1], jnp.int32),
                valid=jnp.asarray([True]),
                dir_pdf=jnp.asarray([r["dir_pdf"]], jnp.float32))
        ill, sxy, smask = bdpt._estimate_radiance(
            scene, i_eye, i_light, eye, light, jax.random.key(0),
            W, H, cfg, debug_inject=inject or None)
        mine = np.asarray(ill[0])
        refv = np.asarray(ref["ill"])
        scale = max(np.abs(refv).max(), 1e-3)
        np.testing.assert_allclose(
            mine, refv, atol=2e-2 * scale, rtol=2e-2,
            err_msg=f"{os.path.basename(dump_path)} combo "
                    f"(s={i_eye}, t={i_light}) ref={refv} mine={mine}")
        if i_eye == 1 and smask is not None and bool(smask[0]):
            assert tuple(np.asarray(sxy[0])) == ref["xy"], (i_eye, i_light)
        checked += 1
    assert checked == len(est_d) and checked >= 10
