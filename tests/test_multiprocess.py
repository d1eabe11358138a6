"""Multi-process distributed render == single-process render, bitwise.

Launches real OS processes (gloo CPU collectives, 2 virtual devices
each), renders a tiny BDPT frame through parallel/launch.py, and compares
against the same render on this process's single-host 8-device mesh AND
the plain driver.  The counter-based RNG makes all of them bitwise
identical (SURVEY.md section 2.5 determinism row).  Two matrix points:

  * 2 processes x 2 devices -> 4-device global mesh (dp2 x sp2)
  * 4 processes x 2 devices -> 8-device global mesh (dp4 x sp2), the
    VERDICT r04 #6 hardening: the dp axis crosses THREE process
    boundaries, so frame assembly gathers slabs that never share a host.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.conftest import REFERENCE, reference_available

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not reference_available(), reason="no reference"),
]

SCENE = f"{REFERENCE}/dae/sky/CBspheres_lambertian.dae"
W, H, SPP, DEPTH = 32, 24, 2, 3

WORKER_TMPL = textwrap.dedent("""
    import os, sys, json
    pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
    # force the CPU backend through jax.config (env vars are read only
    # when jax is first imported)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    sys.path.insert(0, %(repo)r)
    from bidirectional_pathtracing.parallel import launch
    launch.initialize("127.0.0.1:" + port, num_processes=%(nprocs)d,
                      process_id=pid)
    import jax
    assert jax.process_count() == %(nprocs)d
    assert len(jax.devices()) == %(nprocs)d * 2
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.scene.build import load_scene
    cfg = RenderConfig(spp=%(spp)d, max_ray_depth=%(depth)d, width=%(w)d,
                       height=%(h)d, integrator="bdpt", seed=0)
    scene, _ = load_scene(%(scene)r, %(w)d, %(h)d)
    eye, light, combined = launch.render_frame_multihost(scene, cfg, sp=2)
    if pid == 0:
        import numpy as np
        np.savez(out, eye=eye, light=light, combined=combined)
    print("proc", pid, "ok")
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_multiprocess(nprocs, out):
    worker = WORKER_TMPL % dict(repo="/root/repo", scene=SCENE, w=W, h=H,
                                spp=SPP, depth=DEPTH, nprocs=nprocs)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(i), port, out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd="/root/repo") for i in range(nprocs)]
    logs = []
    for p in procs:
        o, _ = p.communicate(timeout=560)
        logs.append(o.decode())
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return np.load(out)


def _single_process_oracle():
    """The same frame on this process's 8 virtual devices (dp4 x sp2)."""
    from bidirectional_pathtracing.config import RenderConfig
    from bidirectional_pathtracing.parallel.render import (
        make_render_mesh, render_frame_sharded)
    from bidirectional_pathtracing.scene.build import load_scene
    cfg = RenderConfig(spp=SPP, max_ray_depth=DEPTH, width=W, height=H,
                       integrator="bdpt", seed=0)
    scene, _ = load_scene(SCENE, W, H)
    mesh = make_render_mesh(sp=2)
    return render_frame_sharded(scene, cfg, mesh=mesh)


def test_two_process_render_bitwise_equal(tmp_path):
    mp = _run_multiprocess(2, str(tmp_path / "mp2.npz"))
    eye1, light1, combined1 = _single_process_oracle()
    np.testing.assert_array_equal(mp["eye"], np.asarray(eye1))
    np.testing.assert_array_equal(mp["light"], np.asarray(light1))
    np.testing.assert_array_equal(mp["combined"], np.asarray(combined1))


def test_four_process_render_bitwise_equal(tmp_path):
    """4 gloo processes x 2 virtual devices = the full 8-device dp4 x sp2
    mesh split across process boundaries (VERDICT r04 #6)."""
    mp = _run_multiprocess(4, str(tmp_path / "mp4.npz"))
    eye1, light1, combined1 = _single_process_oracle()
    np.testing.assert_array_equal(mp["eye"], np.asarray(eye1))
    np.testing.assert_array_equal(mp["light"], np.asarray(light1))
    np.testing.assert_array_equal(mp["combined"], np.asarray(combined1))
