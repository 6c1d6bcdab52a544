"""Environment-map processing: RGBE decode, gradient environments, and
radiance-bin computation for HDRi importance sampling.

Parity with reference env_sampler.js:1-74 (recursive bi-tree split of the
equirect image into boxes of bounded radiance) and main.js:182-204 (vertical
gradient environments from color stops).  The O(pixels x depth) radiance sums
of the reference are replaced by an O(pixels) summed-area table, producing the
identical split sequence for power-of-two images.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

LUMA = np.array([0.2126, 0.7152, 0.0722])


def decode_rgbe(pixels: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 RGBE -> (H, W, 3) float32 linear radiance
    (reference env_sampler.js:14-22 and tracer.fs:410-414:
    rgb * 2^(e-128) / 255)."""
    p = pixels.astype(np.float32)
    power = np.exp2(p[..., 3] - 128.0)
    return (p[..., :3] / 255.0) * power[..., None]


def encode_rgbe(radiance: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) uint8 RGBE, inverse of decode_rgbe."""
    r = np.maximum(radiance, 0.0).astype(np.float32)
    maxc = r.max(axis=-1)
    e = np.where(maxc > 1e-32,
                 np.ceil(np.log2(np.maximum(maxc, np.float32(1e-32))
                                 / np.float32(255.0 / 256.0))),
                 np.float32(-128.0)).astype(np.float32)
    scale = np.exp2(e)
    rgb = np.clip(np.round(r / scale[..., None] * 255.0), 0, 255)
    return np.concatenate(
        [rgb, (e + 128.0)[..., None]], axis=-1).astype(np.uint8)


def gradient_environment(stops: Sequence[Sequence[float]], height: int = 2048) -> np.ndarray:
    """Vertical-gradient environment from color stops -> (height, 1, 3) f32
    (reference main.js:182-204: 1 x 2048 RGB32F texture, lerp between stops)."""
    stops_arr = np.asarray(stops, dtype=np.float32)
    n = len(stops_arr) - 1
    rows = np.arange(height)
    seg = np.minimum((rows // (height / n)).astype(np.int64), n - 1)
    range_pixels = height / n
    sigma = ((rows % range_pixels) / range_pixels).astype(np.float32)
    colors = (stops_arr[seg] * (1.0 - sigma[:, None])
              + stops_arr[seg + 1] * sigma[:, None])
    return colors.reshape(height, 1, 3)


@dataclasses.dataclass
class EnvBins:
    boxes: np.ndarray          # (B, 4) int32 [x0, y0, x1, y1] in pixels
    width: int
    height: int


def compute_radiance_bins(radiance: np.ndarray, bins_divisor: float = 64.0) -> EnvBins:
    """Bi-tree split of the equirect radiance image into boxes whose summed
    luma is <= max(total/64, brightest/2) (reference env_sampler.js:24-72).

    Splits halve the longest axis; identical box sequence to the reference for
    power-of-two dimensions (the reference uses float midpoints which stay
    integral for pow2 inputs).
    """
    h, w = radiance.shape[:2]
    luma = radiance[..., 0] * LUMA[0] + radiance[..., 1] * LUMA[1] + radiance[..., 2] * LUMA[2]
    # Summed-area table with a zero row/col front pad: sums over [y0,y1)x[x0,x1)
    sat = np.zeros((h + 1, w + 1), dtype=np.float64)
    np.cumsum(np.cumsum(luma, axis=0), axis=1, out=sat[1:, 1:])

    def box_sum(x0, y0, x1, y1):
        return sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]

    total = float(sat[h, w])
    brightest = float(luma.max()) if luma.size else 0.0
    min_radiance = max(total / bins_divisor, brightest / 2.0)

    boxes: List[List[int]] = []
    # Iterative DFS matching the reference's recursion order (first half then
    # second half) so bin ordering is identical.
    stack = [(total, 0, 0, w, h)]
    out_of_order: List = []
    while stack:
        rad, x0, y0, x1, y1 = stack.pop()
        if rad <= min_radiance or (y1 - y0) * (x1 - x0) < 2:
            boxes.append([x0, y0, x1, y1])
            continue
        vert = (x1 - x0) > (y1 - y0)
        if vert:
            xs, ys = x0 + (x1 - x0) // 2, y1
        else:
            xs, ys = x1, y0 + (y1 - y0) // 2
        sub = box_sum(x0, y0, xs, ys)
        # push second half first so the first half is processed first
        if vert:
            stack.append((rad - sub, xs, y0, x1, y1))
        else:
            stack.append((rad - sub, x0, ys, x1, y1))
        stack.append((sub, x0, y0, xs, ys))
    del out_of_order
    return EnvBins(boxes=np.asarray(boxes, dtype=np.int32).reshape(-1, 4),
                   width=w, height=h)


def single_bin(width: int, height: int) -> EnvBins:
    """Whole-image single bin, used for gradient/black environments
    (reference main.js:292: radianceBins = [0, 0, 1, 2048])."""
    return EnvBins(boxes=np.array([[0, 0, width, height]], dtype=np.int32),
                   width=width, height=height)
