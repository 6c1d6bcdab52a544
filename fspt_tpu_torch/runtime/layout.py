"""Framebuffer pixel layout: tile order for packet coherence.

The Pallas traversal kernel walks rays in 1024-lane packets that share one
node stack; packet cost is the union of its rays' BVH paths, so packets
should be *square image tiles*, not raster rows.  Measured on v5e: 32x32
tiles cut mean visited nodes ~3.5x vs 1024-pixel raster strips.

The renderer therefore keeps the accumulation buffer in tile order for the
whole progressive loop and un-permutes once at image-assembly time (host
side, free compared to a per-sample device gather).
"""

from __future__ import annotations

import numpy as np

TILE = 32   # 32*32 == one 1024-ray packet


def tile_order(width: int, height: int, tile: int = TILE) -> np.ndarray:
    """Row-major pixel ids in tile-scan order: perm[k] = pixel id of the
    k-th ray lane.  Partial edge tiles are handled (any width/height)."""
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    out = []
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            out.append(idx[ty:ty + tile, tx:tx + tile].ravel())
    return np.concatenate(out).astype(np.int32)


def untile(flat_tiled: np.ndarray, width: int, height: int,
           tile: int = TILE) -> np.ndarray:
    """Invert tile_order on a host array of shape (..., width*height)
    indexed in tile order -> (..., height, width) row-major image."""
    perm = tile_order(width, height, tile)
    out = np.empty_like(flat_tiled)
    out[..., perm] = flat_tiled
    return out.reshape(flat_tiled.shape[:-1] + (height, width))
