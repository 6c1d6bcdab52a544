"""Texture-atlas packing: every material map (image or flat color) becomes one
layer of a square (L, R, R, 4) float32 array.

Parity with reference texture_packer.js:5-185, minus the WebGL round-trip: the
reference rasterizes each layer through a hidden GL context (blit shader doing
resize, channel swizzle, sRGB decode for color maps, premultiply) and reads it
back with readPixels; here the same pipeline is plain NumPy/PIL array ops.

Layer semantics:
  * dedup by source path / color key (texture_packer.js:13-34)
  * atlas resolution = min(requested, max source image height)
    (texture_packer.js:36-42)
  * `swizzle`: 4-permutation of source channels applied before premultiply
    (texture_packer.js:113-119), used for metallicRoughness channel orders
  * `corrected` (sRGB) images are decoded to linear before storing
    (texture_packer.js:162-166); flat colors are stored as-is
  * premultiply rgb *= alpha; stored alpha = 1 (texture_packer.js:120)

Row convention: layers are stored top-down (row 0 = image top); the device
sampler maps uv v=0 to the bottom row, matching the OBJ/GL convention the
reference achieves with its y-flip blit + readPixels double flip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode (what SRGB8_ALPHA8 sampling does in GL)."""
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


@dataclasses.dataclass
class _Entry:
    kind: str                     # "image" | "color"
    data: Union[np.ndarray, Sequence[float]]
    corrected: bool = False
    swizzle: Optional[Sequence[int]] = None


class TexturePacker:
    """Collects maps during material resolution, then packs once."""

    def __init__(self, atlas_res: int = 2048):
        self.requested_res = atlas_res
        self.entries: List[_Entry] = []
        self.keys: Dict[str, int] = {}
        self.max_res = 1

    def add_texture(self, image: np.ndarray, key: str, corrected: bool = False,
                    swizzle: Optional[Sequence[int]] = None) -> int:
        """image: (H, W, C) uint8 or float in [0,1]. Returns layer index."""
        if key in self.keys:
            return self.keys[key]
        self.max_res = max(self.max_res, image.shape[0])
        idx = len(self.entries)
        self.entries.append(_Entry("image", image, corrected, swizzle))
        self.keys[key] = idx
        return idx

    def add_color(self, color: Sequence[float]) -> int:
        key = " ".join(str(c) for c in color)
        if key in self.keys:
            return self.keys[key]
        idx = len(self.entries)
        self.entries.append(_Entry("color", list(color)))
        self.keys[key] = idx
        return idx

    @property
    def resolution(self) -> int:
        return min(self.requested_res, self.max_res)

    def pack(self) -> np.ndarray:
        """-> (L, R, R, 4) float32 atlas (premultiplied, linearized)."""
        res = self.resolution
        out = np.zeros((max(len(self.entries), 1), res, res, 4), dtype=np.float32)
        out[..., 3] = 1.0
        for i, e in enumerate(self.entries):
            if e.kind == "color":
                c = np.asarray(e.data, dtype=np.float32)
                # flat colors round-trip through an 8-bit canvas in the
                # reference (main.js:156-168 createFlatTexture)
                c = np.floor(np.clip(c, 0, 1) * 255.0) / 255.0
                out[i, :, :, :3] = c[:3]
            else:
                img = np.asarray(e.data)
                if img.dtype == np.uint8:
                    img = img.astype(np.float32) / 255.0
                else:
                    img = img.astype(np.float32)
                if img.ndim == 2:
                    img = img[..., None]
                if img.shape[-1] == 1:
                    img = np.repeat(img, 3, axis=-1)
                if img.shape[-1] == 3:
                    img = np.concatenate(
                        [img, np.ones_like(img[..., :1])], axis=-1)
                img = _resize_bilinear(img, res, res)
                if e.swizzle is not None:
                    sw = list(e.swizzle) + [3] * (4 - len(e.swizzle))
                    img = img[..., sw[:4]]
                if e.corrected:
                    img = np.concatenate(
                        [srgb_to_linear(img[..., :3]), img[..., 3:]], axis=-1)
                img = np.concatenate(
                    [img[..., :3] * img[..., 3:4], np.ones_like(img[..., 3:4])],
                    axis=-1)
                out[i] = img
        return out


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize with edge clamping (GL LINEAR sampling of the blit)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    c = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return (a + b + c + d).astype(img.dtype)
