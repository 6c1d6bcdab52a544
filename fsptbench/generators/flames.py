"""The torches' flames (kind `flames`): an icosphere of `subdivisions`
scaled to `size` ([x, y, z] half-extents) at each point of `at`, as one
OBJ; the prop's emittance makes every triangle an area light."""

import numpy as np

from fsptbench.generators.relief import icosphere, obj_text


def make(params):
    unit, faces = icosphere(params["subdivisions"])
    size = np.asarray(params["size"], np.float64)
    verts = [unit * size + np.asarray(p, np.float64) for p in params["at"]]
    return obj_text(np.concatenate(verts),
                    np.concatenate([faces + i * len(unit)
                                    for i in range(len(verts))]))
