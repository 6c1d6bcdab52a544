"""The dungeon's boulders (kind `boulders`): `count` icospheres of
`subdivisions`, lumpy and flattened, laid out by a seeded draw, as one
OBJ with texture coordinates.

A boulder of radius r in [`radius`] is the unit icosphere with each vertex
moved out by a seeded lump (seeded 3-d waves, up to `lump` of r) and by
`relief.amplitude` times relief.py's height at its texture coordinates
(longitude and latitude over the unit sphere), then squashed to `squash`
in y.  It rests with its lowest point at `rest_y`, clear of the floor's
relief.  Boulders are drawn in x within `span` of the walls (|x| in
[`span`[0], `span`[1] - 1.25 r]) and in z within `z`, each kept clear of
the `pillars` ([x, z, radius]) and of the boulders before it; every seed
gives the same layout.
"""

import numpy as np

from fsptbench.generators.relief import fields, icosphere, obj_text


def _layout(params, rng):
    lo, hi = params["radius"]
    x_in, x_out = params["span"]
    z0, z1 = params["z"]
    placed = []
    for _ in range(100_000):
        if len(placed) == params["count"]:
            return placed
        r = rng.uniform(lo, hi)
        x = rng.uniform(x_in, x_out - 1.25 * r) * rng.choice([-1.0, 1.0])
        z = rng.uniform(z0 + 1.25 * r, z1 - 1.25 * r)
        if all(np.hypot(x - px, z - pz) > pr + 1.25 * r + 0.05
               for px, pz, pr in params["pillars"]) and all(
                np.hypot(x - bx, z - bz) > 1.25 * (r + br) + 0.05
                for bx, bz, br in placed):
            placed.append((x, z, r))
    raise ValueError("boulders: no room for the count asked")


def make(params):
    rng = np.random.default_rng(params["seed"])
    rel = params["relief"]
    unit, faces = icosphere(params["subdivisions"])
    lon = np.arctan2(unit[:, 2], unit[:, 0]) / (2.0 * np.pi) + 0.5
    lat = np.arcsin(np.clip(unit[:, 1], -1.0, 1.0)) / np.pi + 0.5
    height = fields(rel["surface"], lon, lat, rel["seed"])["height"]
    # a corner's u, taken across the seam to its face's side
    fu = lon[faces]
    fu = np.where(fu.max(axis=1, keepdims=True) - fu > 0.5, fu + 1.0, fu)
    face_uv = np.stack([fu, lat[faces]], -1).reshape(-1, 2)
    corner = np.arange(faces.size).reshape(-1, 3)
    verts, all_faces, all_uv = [], [], []
    for b, (x, z, r) in enumerate(_layout(params, rng)):
        k = rng.normal(0.0, 1.0, (6, 3)) * 1.5
        ph = rng.uniform(0.0, 2.0 * np.pi, 6)
        lump = np.cos(unit @ k.T + ph).mean(axis=1)
        rad = r * (1.0 + params["lump"] * lump) + rel["amplitude"] * height
        v = unit * rad[:, None] * np.array([1.0, params["squash"], 1.0])
        v += np.array([x, params["rest_y"] - v[:, 1].min(), z])
        all_faces.append(faces + b * len(unit))
        all_uv.append(corner + b * faces.size)
        verts.append(v)
    return obj_text(np.concatenate(verts), np.concatenate(all_faces),
                    np.tile(face_uv, (len(verts), 1)),
                    np.concatenate(all_uv))
