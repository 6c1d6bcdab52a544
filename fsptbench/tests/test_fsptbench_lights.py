"""A configuration added as new files and entries only, whose meshes and
maps come from generator files of its own and whose render runs light
NEE: a closed room of quads lit by an emissive ceiling quad, with a
metallic icosphere and a dielectric block.  The harness runs it correct
with and without the wavefront batch; the program with its light term's
MIS weight forced to 1 is not.

`lit_bench(root, size)` writes the configuration into a copy of the
benchmark under `root` and returns its manifest and cell, for a run on
the card at the benchmark's own size as well."""

import json
import os
import sys

import pytest
import torch

from conftest import make_small
from fsptbench.control import run_control
from fsptbench.manifest import Manifest
from fsptbench.run import run_cell

SEED = 2_987_654_321
CELL = "lit.progressive"

# generators/box.py: the cube [-0.5, 0.5]^3 as six quads, each with
# texture coordinates over its face; wound so that the faces' normals point
# out, or in where params["inward"]
BOX = '''
import numpy as np


def make(params):
    verts, uvs, faces = [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3)
            n[axis] = sign
            a = np.zeros(3)
            a[(axis + 1) % 3] = 0.5
            b = np.cross(n, a)
            corners = [0.5 * n - a - b, 0.5 * n + a - b, 0.5 * n + a + b,
                       0.5 * n - a + b]
            if params.get("inward"):
                corners = corners[::-1]
            base = len(verts)
            verts += corners
            uvs += [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
            for i, j, k in ((0, 1, 2), (2, 3, 0)):
                faces.append((base + i, base + j, base + k))
    out = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    out += [f"vt {u:.1f} {v:.1f}" for u, v in uvs]
    out += ["f " + " ".join(f"{i + 1}/{i + 1}" for i in f) for f in faces]
    return "\\n".join(out) + "\\n"
'''

# generators/tiles.py: a tangent-space normal map of square tiles with
# bevelled edges, as RGBA uint8
TILES = '''
import numpy as np


def make(params):
    res, tiles, bevel = params["res"], params["tiles"], params["bevel"]
    x = (np.arange(res) + 0.5) / res * tiles % 1.0
    edge = np.minimum(x, 1.0 - x) / bevel
    slope = np.where(edge < 1.0, np.where(x < 0.5, 1.0, -1.0), 0.0)
    nx = np.broadcast_to(-slope[None, :], (res, res))
    ny = np.broadcast_to(slope[:, None], (res, res))
    n = np.stack([nx, ny, np.ones((res, res))], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = np.round((n * 0.5 + 0.5) * 255.0)
    alpha = np.full((res, res, 1), 255.0)
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)
'''

# the ball and the block stand clear of the floor: a face coplanar with
# another is a tie that the program's tree and the reference's may break
# apart
SCENE = {
    "cameraPos": [0.0, -0.2, 1.7],
    "cameraDir": [-0.05, -0.3, -1.0],
    "fovScale": 0.6,
    "samples": 2000,
    "atlasRes": 256,
    "props": [
        {"path": "room.obj", "scale": 4.0, "normals": "flat",
         "diffuse": "checker.png", "normal": "tiles.png",
         "metallicRoughness": [0.0, 0.7, 0.0]},
        {"path": "light.obj", "scale": 1.2, "translate": [0.0, 1.98, 0.0],
         "rotate": [{"axis": [1.0, 0.0, 0.0], "angle": 3.14159265}],
         "normals": "flat", "diffuse": [1.0, 1.0, 1.0],
         "emittance": [12.0, 11.0, 9.0]},
        {"path": "ball.obj", "scale": 0.45,
         "translate": [-0.7, -1.54, -0.6], "normals": "smooth",
         "diffuse": [0.9, 0.7, 0.4], "metallicRoughness": [1.0, 0.5, 0.0]},
        {"path": "block.obj", "scale": 0.7,
         "translate": [0.6, -1.64, -0.2], "normals": "flat",
         "diffuse": [0.85, 0.95, 0.9], "ior": 1.5, "dielectric": 0.4},
    ],
}

ASSETS = {
    "room.obj": {"kind": "box", "inward": True},
    "block.obj": {"kind": "box"},
    "light.obj": {"kind": "quad"},
    "ball.obj": {"kind": "icosphere", "subdivisions": 3},
    "checker.png": {"kind": "checker", "res": 256, "squares": 8},
    "tiles.png": {"kind": "tiles", "res": 256, "tiles": 4, "bevel": 0.08},
}


def lit_bench(root, size, wavefront=True):
    """The benchmark's data under `root` plus the configuration `lit`
    (bunny8_main's render fields at size x size, light NEE on) and its
    cell under the progressive mix and limits: (manifest, cell)."""
    bench = make_small(root, size).bench
    os.makedirs(os.path.join(bench, "generators"), exist_ok=True)
    for kind, src in (("box", BOX), ("tiles", TILES)):
        with open(os.path.join(bench, "generators", f"{kind}.py"), "w") as f:
            f.write(src.lstrip())
    with open(os.path.join(bench, "configs", "bunny8_main.json")) as f:
        render = json.load(f)["render"]
    render.update(use_light_nee=True, wavefront_batch=wavefront)
    cfg = {"name": "lit", "reduced": [], "scene": SCENE, "assets": ASSETS,
           "loader": {"leaf_size": 8, "env_bins_cap": 256, "bvh_width": 8},
           "render": render}
    with open(os.path.join(bench, "configs", "lit.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "checks",
                           "bunny8_main.progressive.json")) as f:
        limits = json.load(f)
    with open(os.path.join(bench, "checks", f"{CELL}.json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "lit", "source": "test",
                         "file": "fsptbench/configs/lit.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": CELL, "config": "lit",
                           "traffic": "progressive", "chips": 1,
                           "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "bunny8_main.progressive" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(b, f)
    return Manifest(path, bench), CELL


def light_weight_one(mp):
    """The program's fault: its light term's MIS weight forced to 1 (the
    call of brdf.mis_weights that weighs `pdf_l`), while an emitter that a
    path hits keeps its own weight."""
    from fspt_tpu_torch.core import brdf
    real = brdf.mis_weights

    def mis_weights(a, b, *args, **kw):
        if a is sys._getframe(1).f_locals.get("pdf_l"):
            return torch.ones_like(a), torch.zeros_like(a)
        return real(a, b, *args, **kw)
    mp.setattr(brdf, "mis_weights", mis_weights)


@pytest.fixture(scope="module")
def lit(tmp_path_factory):
    return {w: lit_bench(str(tmp_path_factory.mktemp(f"lit{w}")), 32, w)
            for w in (True, False)}


@pytest.mark.parametrize("wavefront", [True, False],
                         ids=["wavefront", "per_sample"])
def test_lit_configuration_runs_correct(lit, wavefront):
    m, cell = lit[wavefront]
    r = run_cell(cell, SEED, 0.5, False, "cpu", m)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_light_weight_forced_to_one_is_not_correct(lit, monkeypatch):
    light_weight_one(monkeypatch)
    m, cell = lit[True]
    r = run_cell(cell, SEED, 0.5, False, "cpu", m)
    assert not r["correct"], r["checks"]


def test_lit_control_is_rejected(lit):
    m, cell = lit[True]
    out = run_control(cell, SEED, "cpu", m)
    assert any(out["control"][k] > out["limits"][k] for k in out["limits"])


def test_reference_lists_the_lights(lit):
    from fsptbench.reference.scene import compile_scene
    from fsptbench.scenegen import Assets
    m, _ = lit[True]
    c = m.config("lit")
    s = compile_scene(c["scene"], Assets(c["assets"], m.bench), "cpu")
    # the room's 12 triangles come first; the light quad's 2 follow
    assert s.lights.tolist() == [12, 13]
    assert s.light_area == pytest.approx(1.2 ** 2, rel=1e-6)
    assert s.light_cdf.tolist() == pytest.approx([0.5, 1.0], rel=1e-6)
