"""The viewer's display frame, stated plainly: mean radiance in tile order
-> row-major image -> exposure, ACES fitted tone map, saturation and gamma
(upstream draw.fs:39-93, without the firefly filter) -> 8-bit pixels."""

from __future__ import annotations

import numpy as np
import torch

from fsptbench.reference.render import tile_order

LUMA = (0.2126, 0.7152, 0.0722)
ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566),
           (0.02840, 0.13383, 0.83777))
ACES_OUT = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605),
            (-0.00327, -0.07276, 1.07602))


def _mix(m, c):
    return [m[i][0] * c[0] + m[i][1] * c[1] + m[i][2] * c[2]
            for i in range(3)]


def display(img, exposure, saturation, gamma):
    """(3, H, W) radiance -> (3, H, W) display values in [0, 1]."""
    c = [img[i] * exposure for i in range(3)]
    c = _mix(ACES_IN, c)
    c = [(v * (v + 0.0245786) - 0.000090537)
         / (v * (0.983729 * v + 0.4329510) + 0.238081) for v in c]
    c = [torch.clamp(v, 0.0, 1.0) for v in _mix(ACES_OUT, c)]
    lum = LUMA[0] * c[0] + LUMA[1] * c[1] + LUMA[2] * c[2]
    c = [lum + (v - lum) * saturation for v in c]
    return torch.stack([torch.pow(torch.clamp(v, 0.0, 1.0), 1.0 / gamma)
                        for v in c])


def frame(hdr_sum, width: int, height: int, post: dict,
          samples: int = 1) -> np.ndarray:
    """(H, W, 3) uint8 display frame of a radiance sum over `samples`
    samples, (n, 3) in the framebuffer's lane order."""
    if post.get("denoise"):
        raise NotImplementedError("reference frame: the firefly filter")
    mean = (hdr_sum / float(samples)).T.contiguous()
    img = torch.empty_like(mean)
    img[:, torch.from_numpy(tile_order(width, height)).to(mean.device)] = mean
    out = display(img.reshape(3, height, width), post["exposure"],
                  post["saturation"], post["gamma"])
    out = np.clip(np.moveaxis(out.cpu().numpy(), 0, -1), 0.0, 1.0)
    return (out * 255.0 + 0.5).astype(np.uint8)
