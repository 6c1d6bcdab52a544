"""Image comparison tool.

Replaces the reference's manual browser diff page (reference
tools/index.html + tools/image_tool.js: load two images, run a user-editable
comparison shader by eyeball) with a scriptable comparator that both renders
a diff image and *asserts*: it returns quantitative metrics usable in CI —
the test layer the reference never had (SURVEY §4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DiffResult:
    mse: float
    rmse: float
    psnr_db: float
    max_abs: float
    mean_abs: float
    frac_above: float      # fraction of pixels with |diff| > threshold
    shape: tuple

    def as_dict(self):
        return dataclasses.asdict(self)


def compare(a: np.ndarray, b: np.ndarray, threshold: float = 1.0 / 255.0
            ) -> DiffResult:
    """Compare two (H, W, 3) float images in [0, 1]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    d = a - b
    mse = float((d * d).mean())
    max_abs = float(np.abs(d).max())
    psnr = float(10.0 * np.log10(1.0 / mse)) if mse > 0 else float("inf")
    return DiffResult(
        mse=mse, rmse=float(np.sqrt(mse)), psnr_db=psnr, max_abs=max_abs,
        mean_abs=float(np.abs(d).mean()),
        frac_above=float((np.abs(d).max(axis=-1) > threshold).mean()),
        shape=a.shape)


def diff_image(a: np.ndarray, b: np.ndarray, mode: str = "rg",
               gain: float = 1.0) -> np.ndarray:
    """Render a diff visualization.

    mode "rg": channel-0 of each image into R/G (the reference's default
    shader, tools/index.html:27-41).  mode "abs": amplified |a-b|.
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if mode == "rg":
        out = np.zeros_like(a)
        out[..., 0] = a[..., 0]
        out[..., 1] = b[..., 0]
        return np.clip(out * gain, 0.0, 1.0)
    return np.clip(np.abs(a - b) * gain, 0.0, 1.0)


def expr_image(a: np.ndarray, b: np.ndarray, expr: str,
               gain: float = 1.0) -> np.ndarray:
    """User-editable comparison expression — the scriptable analog of the
    reference's editable diff shader (reference tools/image_tool.js:46-119,
    default shader tools/index.html:27-41).  `expr` is a NumPy expression
    over (H, W, 3) float arrays `a` and `b` (plus `np`), e.g.
    "abs(a - b)" or "np.stack([a[...,0], b[...,0], 0*a[...,0]], -1)".
    Same trust model as the reference (the user supplies the code)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    out = eval(expr, {"np": np, "abs": np.abs}, {"a": a, "b": b})
    out = np.asarray(out, np.float32)
    if out.ndim == 2:                       # scalar field -> grayscale
        out = np.repeat(out[..., None], 3, axis=-1)
    if out.shape != a.shape:
        raise ValueError(f"expr produced shape {out.shape}; "
                         f"expected {a.shape} or {a.shape[:2]}")
    return np.clip(out * gain, 0.0, 1.0)


def main(argv: Optional[list] = None) -> int:
    import argparse
    import json

    from fspt_tpu_torch.io.image import read_png, write_png

    p = argparse.ArgumentParser(prog="fspt diff",
                                description="compare two renders")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("-o", "--out", help="write diff visualization PNG")
    p.add_argument("--mode", choices=["rg", "abs"], default="abs")
    p.add_argument("--expr", default=None,
                   help="custom NumPy comparison expression over images "
                        "`a` and `b`, e.g. 'abs(a-b)' (overrides --mode; "
                        "the reference's editable diff shader)")
    p.add_argument("--gain", type=float, default=4.0)
    p.add_argument("--max-rmse", type=float, default=None,
                   help="exit nonzero if RMSE exceeds this")
    args = p.parse_args(argv)

    a = read_png(args.a)
    b = read_png(args.b)
    res = compare(a, b)
    print(json.dumps(res.as_dict()))
    if args.out:
        if args.expr:
            vis = expr_image(a, b, args.expr, gain=args.gain)
        else:
            vis = diff_image(a, b, mode=args.mode, gain=args.gain)
        write_png(args.out, vis)
    if args.max_rmse is not None and res.rmse > args.max_rmse:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
