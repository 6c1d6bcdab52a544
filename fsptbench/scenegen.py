"""The scene inputs of a configuration, made by the benchmark and handed
alike to the program and to the plain reference: OBJ text, RGBA images and
the scene dict (upstream FSPT's scene JSON schema).

A configuration file names its assets under "assets", each with a
generator `kind` and its parameters.  A kind of this module's GENERATORS
is built in; any other kind is the `make(params)` of
`<bench>/generators/<kind>.py`, which returns OBJ text (str) or an RGBA
uint8 image (H, W, 4).  A generator file imports nothing of the program
(importcheck), so the program never makes its own inputs.  The
generators are fixed functions of their parameters, so the inputs of a
configuration are the same in every run.
"""

from __future__ import annotations

import io
import os

import numpy as np

from fsptbench.manifest import BENCH, load_module


def icosphere_obj(subdivisions: int) -> str:
    """A unit icosphere of 20 * 4^subdivisions faces, as OBJ text (midpoints
    numbered in first-encounter order over each face's edges ab, bc, ca)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int64)
    for _ in range(subdivisions):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.sort(np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                                  np.stack([c, a], 1)], axis=1)
                        .reshape(-1, 2), axis=1)
        uniq, first, inv = np.unique(edges, axis=0, return_index=True,
                                     return_inverse=True)
        rank = np.empty(len(uniq), np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        base = len(verts)
        verts = np.concatenate([verts, mids[np.argsort(rank, kind="stable")]])
        new = base + rank[inv.reshape(-1)].reshape(-1, 3)
        ab, bc, ca = new[:, 0], new[:, 1], new[:, 2]
        faces = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                          np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                         axis=1).reshape(-1, 3)
    buf = io.StringIO()
    buf.write("".join(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n" for v in verts))
    buf.write("".join(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n" for f in faces))
    return buf.getvalue()


def quad_obj() -> str:
    """A unit floor quad in the XZ plane, wound so its normal points +y."""
    return ("v 0.5 0.0 0.5\nv 0.5 0.0 -0.5\nv -0.5 0.0 -0.5\nv -0.5 0.0 0.5\n"
            "vt 0.0 0.0\nvt 0.0 1.0\nvt 1.0 1.0\nvt 1.0 0.0\n"
            "f 1/1 2/2 3/3\nf 3/3 4/4 1/1\n")


def encode_rgbe(radiance: np.ndarray) -> np.ndarray:
    r = np.maximum(radiance, 0.0).astype(np.float32)
    maxc = r.max(axis=-1)
    e = np.where(maxc > 1e-32,
                 np.ceil(np.log2(np.maximum(maxc, np.float32(1e-32))
                                 / np.float32(255.0 / 256.0))),
                 np.float32(-128.0)).astype(np.float32)
    rgb = np.clip(np.round(r / np.exp2(e)[..., None] * 255.0), 0, 255)
    return np.concatenate([rgb, (e + 128.0)[..., None]],
                          axis=-1).astype(np.uint8)


def sky_rgbe(width: int, height: int, sun_u: float, sun_v: float,
             sun_radiance: float) -> np.ndarray:
    """An equirect sky (a gradient and a sun disk) as RGBE pixels."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    horizon = np.clip(1.0 - np.abs(vv - 0.5) * 2.0, 0.0, 1.0)
    sky = np.stack([0.2 + 0.3 * horizon, 0.35 + 0.35 * horizon,
                    0.7 + 0.2 * horizon], axis=-1)
    du = np.minimum(np.abs(uu - sun_u), 1.0 - np.abs(uu - sun_u)) * 2.0
    sun = (du ** 2 + np.abs(vv - sun_v) ** 2) < 0.03 ** 2
    rad = np.where(sun[..., None], np.array([1.0, 0.95, 0.8]) * sun_radiance,
                   sky)
    return encode_rgbe(rad.astype(np.float32))


def checker(res: int, squares: int) -> np.ndarray:
    idx = np.arange(res) * squares // res
    board = (idx[:, None] + idx[None, :]) % 2
    return np.where(board[..., None] == 0,
                    np.array([200, 60, 60, 255], np.uint8),
                    np.array([240, 240, 240, 255], np.uint8)).astype(np.uint8)


GENERATORS = {
    "icosphere": lambda p: icosphere_obj(p["subdivisions"]),
    "quad": lambda p: quad_obj(),
    "sky_rgbe": lambda p: sky_rgbe(p["width"], p["height"], p["sun_u"],
                                   p["sun_v"], p["sun_radiance"]),
    "checker": lambda p: checker(p["res"], p["squares"]),
}


def generator(kind: str, bench: str = BENCH):
    """The function that makes assets of `kind`: a built-in one, or the
    `make` of <bench>/generators/<kind>.py."""
    if kind in GENERATORS:
        return GENERATORS[kind]
    path = os.path.join(bench, "generators", f"{kind}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no asset generator {kind!r}: {path} does not exist")
    return load_module(path, "fsptbench.generators."
                       + kind.replace(".", "_")).make


def _checked(name: str, item):
    if isinstance(item, str):
        return item
    if (isinstance(item, np.ndarray) and item.dtype == np.uint8
            and item.ndim == 3 and item.shape[2] == 4):
        return item
    raise TypeError(f"asset {name!r}: a generator returns OBJ text or an "
                    f"RGBA uint8 (H, W, 4) array, not {type(item).__name__}"
                    f" {getattr(item, 'dtype', '')}"
                    f"{getattr(item, 'shape', '')}")


class Assets:
    """The asset loader both sides read: OBJ text and RGBA uint8 images by
    the names of the scene dict.  `bench` is the benchmark directory whose
    generators/ holds the kinds that are not built in."""

    def __init__(self, specs: dict, bench: str = BENCH):
        self.items = {
            name: _checked(name, generator(spec["kind"], bench)(spec))
            for name, spec in specs.items()}

    def text(self, path: str) -> str:
        return self.items[path]

    def image(self, path: str) -> np.ndarray:
        return self.items[path]
