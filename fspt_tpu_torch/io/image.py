"""PNG/NPY image IO (replaces the reference's canvas.toBlob upload path,
reference main.js:859-867 + utility.js:46-53)."""

from __future__ import annotations

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float [0,1] or uint8."""
    from PIL import Image
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr, mode="RGB").save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32) / 255.0


def write_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img))
