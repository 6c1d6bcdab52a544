"""The dungeon's colour maps (kind `pbr`), drawn over relief.py's height
fields so that they follow the normal maps' blocks and bands, as RGBA
uint8 at `res` x `res`:

  base_color   stone: blocks of seeded tint, darker joints; rock: dark
               grey with seeded mottling, iron bands (`bands` a tile)
  metal_rough  metallic in red, roughness in green: stone is rough
               dielectric, rougher in the joints; rock's iron bands are
               metallic and smoother
  emissive     rock only: black but for sparse round embers, one in about
               `ember_share` of a `cells` x `cells` grid's cells
"""

import numpy as np

from fsptbench.generators.relief import grid_fields, rgba, waves

BAND_WIDTH = 0.12


def _bands(v, bands):
    return (np.mod(v * bands, 1.0) < BAND_WIDTH).astype(v.dtype)


def _embers(u, v, seed, cells, share):
    rng = np.random.default_rng(seed)
    lit = rng.uniform(0.0, 1.0, (cells, cells)) < share
    centre = rng.uniform(0.3, 0.7, (cells, cells, 2))
    size = rng.uniform(0.06, 0.14, (cells, cells))
    cu, cv = np.mod(u, 1.0) * cells, np.mod(v, 1.0) * cells
    iu = cu.astype(np.int64) % cells
    iv = cv.astype(np.int64) % cells
    du = cu - iu - centre[iv, iu, 0]
    dv = cv - iv - centre[iv, iu, 1]
    glow = np.exp(-(du * du + dv * dv) / size[iv, iu] ** 2)
    return np.where(lit[iv, iu], glow, 0.0).astype(u.dtype)


def make(params):
    surface, which, seed = params["surface"], params["map"], params["seed"]
    u, v, f = grid_fields(surface, params["res"], seed)
    mottle = waves(u, v, seed + 2, 10, 40)
    if surface == "stone":
        joint = f["joint"][..., None]
        if which == "base_color":
            block = np.array([0.46, 0.41, 0.35], np.float32) * (
                0.75 + 0.45 * f["block"] + 0.08 * mottle)[..., None]
            mortar = np.array([0.24, 0.22, 0.19], np.float32)
            return rgba(block * (1.0 - joint) + mortar * joint)
        if which == "metal_rough":
            rough = 0.8 + 0.15 * f["joint"] + 0.03 * mottle
            return rgba(np.stack([np.zeros_like(rough), rough,
                                  np.zeros_like(rough)], axis=-1))
    elif surface == "rock":
        band = _bands(v, params["bands"])[..., None]
        if which == "base_color":
            rock = np.array([0.36, 0.33, 0.30], np.float32) * (
                0.85 + 0.2 * f["height"] + 0.1 * mottle)[..., None]
            iron = np.array([0.52, 0.50, 0.48], np.float32)
            return rgba(rock * (1.0 - band) + iron * band)
        if which == "metal_rough":
            rough = np.where(band[..., 0] > 0, 0.5, 0.9) + 0.03 * mottle
            return rgba(np.stack([band[..., 0], rough,
                                  np.zeros_like(rough)], axis=-1))
        if which == "emissive":
            glow = _embers(u, v, seed + 3, params["cells"],
                           params["ember_share"]) * (1.0 - band[..., 0])
            return rgba(glow[..., None]
                        * np.array([1.0, 0.42, 0.08], np.float32))
    raise ValueError(f"pbr: no {which!r} map of {surface!r}")
