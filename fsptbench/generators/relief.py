"""Tileable height fields of the dungeon's two surfaces, and the
tangent-space normal maps made from them (kind `relief`).

  stone  ashlar blocks in running bond (4 across, 8 up a tile), bevelled
         joints, each block raised by a seeded amount, a seeded grain
  rock   seeded periodic waves, ridged into cracks

`fields(surface, u, v, seed)` gives the height in [-1, 1] at texture
coordinates (u, v), period 1 in both, with the parts the colour maps
(kind `pbr`) follow.  The mesh generators displace their vertices by
`amplitude` times that height, and `make` draws the normal map of the same
height: a bump of the map is a bump of the mesh.  `amplitude` and `tile`
(metres of surface a texture tile spans) set the map's slopes.

The other dungeon generators take their shared helpers from here: the
icosphere of scenegen.py as arrays, and OBJ text from arrays.
"""

import functools

import numpy as np

from fsptbench.scenegen import icosphere_obj

ROWS, COLS, BEVEL = 8, 4, 0.012


def waves(u, v, seed, terms, fmax):
    """A sum of `terms` seeded cosines of integer frequencies up to `fmax`
    (period 1 in u and v), amplitudes falling as 1/frequency, scaled into
    [-1, 1]."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-fmax, fmax + 1, size=(terms, 2))
    k[(k == 0).all(axis=1), 0] = 1
    amp = 1.0 / np.linalg.norm(k, axis=1)
    phase = rng.uniform(0.0, 2.0 * np.pi, terms)
    out = np.zeros(np.broadcast(u, v).shape, np.asarray(u).dtype)
    for (kx, ky), a, ph in zip(k.tolist(), amp.tolist(), phase.tolist()):
        out += a * np.cos(2.0 * np.pi * (kx * u + ky * v) + ph)
    return out / amp.sum()


def _smooth(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def fields(surface, u, v, seed):
    """{"height", and for stone "joint" (1 in a joint, 0 on a block face)
    and "block" (the block's seeded value in [0, 1))} at (u, v)."""
    u = np.asarray(u)
    v = np.asarray(v)
    if surface == "stone":
        y = np.mod(v, 1.0) * ROWS
        row = np.floor(y)
        x = np.mod(u, 1.0) * COLS + 0.5 * np.mod(row, 2.0)
        col = np.floor(x)
        fx, fy = x - col, y - row
        edge = np.minimum(np.minimum(fx, 1.0 - fx) / COLS,
                          np.minimum(fy, 1.0 - fy) / ROWS)
        face = _smooth(edge / BEVEL)
        table = np.random.default_rng(seed).uniform(0.0, 1.0, (ROWS, COLS))
        block = table[row.astype(np.int64) % ROWS,
                      col.astype(np.int64) % COLS].astype(u.dtype)
        grain = waves(u, v, seed + 1, 12, 24)
        height = face * (0.45 + 0.4 * block) + 0.15 * grain - 0.4
        return {"height": np.clip(height, -1.0, 1.0), "joint": 1.0 - face,
                "block": block}
    if surface == "rock":
        w = waves(u, v, seed, 16, 10)
        height = 0.6 * w - 0.5 * np.abs(waves(u, v, seed + 1, 8, 6)) + 0.2
        return {"height": np.clip(height, -1.0, 1.0)}
    raise ValueError(f"relief: no surface {surface!r}")


def grid(res, dtype=np.float32):
    """The (u, v) of every texel of a res x res map, row 0 at v = 1 (the
    atlas fetch reads row (1 - v) * res)."""
    c = ((np.arange(res) + 0.5) / res).astype(dtype)
    return np.meshgrid(c, 1.0 - c)


@functools.lru_cache(maxsize=2)
def grid_fields(surface, res, seed):
    """fields() over grid(res): the maps of one surface share it (do not
    write to its arrays)."""
    u, v = grid(res)
    return u, v, fields(surface, u, v, seed)


def rgba(rgb):
    """(H, W, 3) values in [0, 1] -> RGBA uint8, opaque."""
    out = np.empty(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.round(np.clip(rgb, 0.0, 1.0) * 255.0)
    out[..., 3] = 255
    return out


def make(params):
    res = params["res"]
    h = grid_fields(params["surface"], res, params["seed"])[2]["height"]
    # the height's slope in metres a metre of surface, by central
    # differences with the tile's wrap
    scale = params["amplitude"] / params["tile"] * res / 2.0
    dhdu = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) * scale
    dhdv = (np.roll(h, 1, axis=0) - np.roll(h, -1, axis=0)) * scale
    n = np.stack([-dhdu, -dhdv, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return rgba(n * 0.5 + 0.5)


def icosphere(subdivisions):
    """scenegen.py's unit icosphere as (vertices (V, 3), faces (F, 3)
    0-based)."""
    verts, faces = [], []
    for line in icosphere_obj(subdivisions).splitlines():
        tag, *rest = line.split()
        (verts if tag == "v" else faces).append(rest)
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int64) - 1)


def obj_text(verts, faces, uvs=None, face_uvs=None):
    """OBJ text of vertices (V, 3) and triangles (F, 3) 0-based, with
    texture coordinates (U, 2) and each corner's index into them (F, 3)
    where given."""
    out = [f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts.tolist()]
    faces = (np.asarray(faces) + 1).tolist()
    if uvs is None:
        out += [f"f {a} {b} {c}\n" for a, b, c in faces]
    else:
        out += [f"vt {s:.6f} {t:.6f}\n" for s, t in uvs.tolist()]
        out += [f"f {a}/{ta} {b}/{tb} {c}/{tc}\n" for (a, b, c), (ta, tb, tc)
                in zip(faces, (np.asarray(face_uvs) + 1).tolist())]
    return "".join(out)
