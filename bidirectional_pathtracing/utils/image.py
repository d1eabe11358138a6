"""HDR buffers, tonemapping, and diagnostic images.

Mirrors src/util/image.h and the renderer's save paths:
  - to_color: fixed gamma 2.2 + exposure sqrt(2) transfer
    (HDRImageBuffer::toColor, image.h:194-209)
  - tonemap: Reinhard-style global operator (image.h:162-189)
  - save_image: vertical flip + opaque alpha (raytraced_renderer.cpp:703-719)
  - sampling-rate heatmap (raytraced_renderer.cpp:730-761)
"""

from __future__ import annotations

import numpy as np

from bidirectional_pathtracing.utils.png import write_png

_LUMA = np.array([0.2126, 0.7152, 0.0722])


def to_color(hdr: np.ndarray, gamma: float = 2.2, level: float = 1.0) -> np.ndarray:
    """[H,W,3] float -> uint8 with the reference transfer (image.h:194-209)."""
    exposure = np.sqrt(2.0 ** level)
    v = np.clip(np.power(np.maximum(hdr * exposure, 0.0), 1.0 / gamma), 0.0, 1.0)
    return (v * 255.0).astype(np.uint8)


def tonemap(hdr: np.ndarray, gamma: float = 2.2, level: float = 1.0,
            key: float = 0.18, wht: float = 5.0) -> np.ndarray:
    """HDRImageBuffer::tonemap (image.h:162-189)."""
    lum = hdr @ _LUMA
    avg = np.exp(np.mean(np.log(1e-7 + lum)))
    s = hdr * (key / avg)
    s = s * (((lum + 1) / (wht * wht)) / (lum + 1))[..., None]
    exposure = np.sqrt(2.0 ** level)
    v = np.clip(np.power(np.maximum(s * exposure, 0.0), 1.0 / gamma), 0.0, 1.0)
    return (v * 255.0).astype(np.uint8)


def save_image(path: str, hdr: np.ndarray) -> None:
    """Tonemap + vertical flip + opaque alpha, like save_image
    (raytraced_renderer.cpp:690-728).  hdr rows are bottom-up (pixel (0,0)
    at the bottom-left, matching the reference sample buffer)."""
    rgb = to_color(hdr)[::-1]
    write_png(path, rgb)


def save_sampling_rate_image(path: str, sample_counts: np.ndarray,
                             max_spp: int) -> None:
    """Blue->green->red heatmap of per-pixel sampling rate
    (raytraced_renderer.cpp:730-761).  Writes <out>_rate.png."""
    rate = sample_counts.astype(np.float64) / max_spp
    low = np.clip((0.5 - rate) / 0.5, 0.0, 1.0)
    hi = np.clip((1.0 - rate) / 0.5, 0.0, 1.0)
    c_low = (np.stack([np.zeros_like(low), 1 - low, low], -1))
    c_hi = np.stack([1 - hi, hi, np.zeros_like(hi)], -1)
    c = np.where((rate <= 0.5)[..., None], c_low, c_hi)
    out = (np.clip(c, 0, 1) * 255).astype(np.uint8)[::-1]
    write_png(path[:-4] + "_rate.png" if path.endswith(".png")
              else path + "_rate.png", out)
