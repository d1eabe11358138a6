from bidirectional_pathtracing.scene.types import (  # noqa: F401
    Camera,
    Geometry,
    Lights,
    Materials,
    Scene,
    MAT_DIFFUSE,
    MAT_EMISSION,
    MAT_MIRROR,
    MAT_REFRACTION,
    MAT_GLASS,
    MAT_MICROFACET,
    LIGHT_AREA,
    LIGHT_POINT,
    LIGHT_DIRECTIONAL,
    LIGHT_HEMISPHERE,
)
from bidirectional_pathtracing.scene.collada import load_dae  # noqa: F401
from bidirectional_pathtracing.scene.build import build_scene  # noqa: F401
