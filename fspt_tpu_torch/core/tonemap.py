"""Post-process chain: firefly filter, exposure, ACES fitted tonemap,
saturation, gamma (port of fspt_tpu.core.tonemap).

Images are (3, H, W) channel planes; the ACES channel mixes are unrolled
scalar*plane sums in the JAX version's order.  Image borders clamp to edge.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LUMA = (0.2126, 0.7152, 0.0722)

ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def _mix(m, c):
    return [m[i][0] * c[0] + m[i][1] * c[1] + m[i][2] * c[2]
            for i in range(3)]


def rrt_and_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(channels):
    """[r, g, b] planes -> tonemapped planes, clamped (draw.fs:39-48)."""
    c = _mix(ACES_INPUT, channels)
    c = [rrt_and_odt_fit(x) for x in c]
    c = _mix(ACES_OUTPUT, c)
    return [torch.clamp(x, 0.0, 1.0) for x in c]


def _luma(channels):
    return (LUMA[0] * channels[0] + LUMA[1] * channels[1]
            + LUMA[2] * channels[2])


def filter_fireflies(channels, max_sigma):
    """5x5 neighborhood luma sigma-clamp (draw.fs:50-80): a pixel whose luma
    deviates from the neighborhood mean (center excluded) by more than
    max_sigma * sigma is rescaled to the mean."""
    k = 5
    half = k // 2
    luma = _luma(channels)
    padded = F.pad(luma[None], (half, half, half, half), mode="replicate")[0]
    h, w = luma.shape
    n = k * k - 1
    acc = torch.zeros_like(luma)
    acc2 = torch.zeros_like(luma)
    for dy in range(k):
        for dx in range(k):
            if dy == half and dx == half:
                continue
            s = padded[dy:dy + h, dx:dx + w]
            acc = acc + s
            acc2 = acc2 + s * s
    mean = acc / n
    var = acc2 / n - mean * mean
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    bad = torch.abs(luma - mean) > max_sigma * sigma
    scale = torch.where(bad, mean / torch.clamp(luma, min=1e-12),
                        torch.ones_like(luma))
    return [c * scale for c in channels]


def postprocess(img, exposure=1.0, saturation=1.0, denoise=False,
                max_sigma=2.0, gamma=2.2):
    """(3, H, W) HDR accumulated radiance -> (3, H, W) display [0,1]
    (draw.fs:82-93)."""
    channels = [img[0], img[1], img[2]]
    if denoise:
        channels = filter_fireflies(channels, max_sigma)
    channels = [c * exposure for c in channels]
    mapped = aces_fitted(channels)
    l = _luma(mapped)
    mapped = [l + (c - l) * saturation for c in mapped]
    return torch.stack(
        [torch.pow(torch.clamp(c, 0.0, 1.0), 1.0 / gamma) for c in mapped])
