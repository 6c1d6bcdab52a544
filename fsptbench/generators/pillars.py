"""The hall's pillars (kind `pillars`): open cylinders of `radius`, one at
each [x, z] of `at`, from `bottom` (below the floor) to `top` (through the
vault), `around` x `rows` quads each, wound to face out.  Texture
coordinates run once around (u) and `relief.tile` metres up (v); every
vertex moves out by `relief.amplitude` times relief.py's height there."""

import numpy as np

from fsptbench.generators.relief import fields, obj_text


def make(params):
    n, m = params["around"], params["rows"]
    rel = params["relief"]
    th = 2.0 * np.pi * np.arange(n + 1) / n
    y = np.linspace(params["bottom"], params["top"], m + 1)
    uv = np.stack(np.broadcast_arrays(th[None, :] / (2.0 * np.pi),
                                      y[:, None] / rel["tile"]), -1)
    height = fields(rel["surface"], uv[..., 0], uv[..., 1],
                    rel["seed"])["height"][:, :n]
    radius = params["radius"] + rel["amplitude"] * height      # (m+1, n)
    k, i = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    a, b = k * n + i, k * n + (i + 1) % n
    c, d = (k + 1) * n + (i + 1) % n, (k + 1) * n + i
    ta, tb = k * (n + 1) + i, k * (n + 1) + i + 1
    tc, td = (k + 1) * (n + 1) + i + 1, (k + 1) * (n + 1) + i
    # (cos, sin) about +y with u rising: a quad a -> d -> c faces out
    ring = [np.stack([a, d, c], -1), np.stack([a, c, b], -1)]
    ring_uv = [np.stack([ta, td, tc], -1), np.stack([ta, tc, tb], -1)]
    verts, faces, face_uvs = [], [], []
    for x0, z0 in params["at"]:
        base = len(verts) * (m + 1) * n
        verts.append(np.stack([x0 + radius * np.cos(th[:n]),
                               np.broadcast_to(y[:, None], radius.shape),
                               z0 + radius * np.sin(th[:n])], -1)
                     .reshape(-1, 3))
        faces += [f.reshape(-1, 3) + base for f in ring]
        face_uvs += [f.reshape(-1, 3) for f in ring_uv]
    return obj_text(np.concatenate(verts), np.concatenate(faces),
                    uv.reshape(-1, 2), np.concatenate(face_uvs))
