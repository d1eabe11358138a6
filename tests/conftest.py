import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# tests run on the CPU with 8 virtual devices for sharding checks
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REFERENCE = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE)


@pytest.fixture(scope="session")
def cbspheres_lambertian():
    from bidirectional_pathtracing.scene.build import load_scene
    scene, aux = load_scene(
        f"{REFERENCE}/dae/sky/CBspheres_lambertian.dae", 120, 90)
    return scene, aux


@pytest.fixture(scope="session")
def cbspheres():
    from bidirectional_pathtracing.scene.build import load_scene
    scene, aux = load_scene(f"{REFERENCE}/dae/sky/CBspheres.dae", 120, 90)
    return scene, aux
