"""The dungeon configuration (fsptbench/configs/dungeon8_lit.json) on the
CPU, cut to 32x32 and 2 samples a step, with its own generators at small
parameters: maps of 32 texels, a hall of about 1,800 triangles, a statue
of 2 subdivisions.

The harness runs its cell correct with and without the wavefront batch;
the program with its light term's MIS weight forced to 1, or with the
normal maps ignored, is not, and the bfloat16 control is rejected.  The
generators' outputs are pinned by digest and import nothing of the
program; at their full parameters they make the ~400,000 triangles the
configuration states.  The trace's counts split the shadow lanes into
light and env ones; the spans of the table build, the atlas fetch and the
light NEE open in an eager step, and the step's numbers do not move with
the profiler on.

`dungeon_bench(root, size, ...)` writes the benchmark with the
configuration cut to size under `root`, for a run on the card as well;
`light_weight_one` and `normal_map_ignored` are the faults."""

import copy
import dataclasses
import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fspt_tpu_torch import load_scene_dict, trace
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import brdf, integrator, rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.runtime.renderer import Renderer
from fsptbench import checks, importcheck
from fsptbench.manifest import BENCH, ROOT, Manifest
from fsptbench.reference.render import Reference, config
from fsptbench.reference.scene import compile_scene
from fsptbench.run import run_cell
from fsptbench.scenegen import Assets

torch.set_num_threads(1)

NAME = "dungeon8_lit"
CELL = "dungeon8_lit.progressive"
SEED = 3_141_592_653

# the generators' parameters cut to a size the CPU renders in seconds
SMALL = {
    "hall.obj": dict(floor_segments=18, wall_segments=4, vault_segments=10,
                     length_segments=24, end_rows=4),
    "pillars.obj": dict(around=8, rows=4),
    "boulders.obj": dict(subdivisions=1),
    "flames.obj": dict(subdivisions=1),
    "bunny.obj": dict(subdivisions=2),
}
MAP_RES = 32
SPP = 2
IDX = 2          # the step compared, as the harness keeps a window step

# SHA-256 (first 16 hex digits) of each small asset's bytes
DIGESTS = {
    "boulders.obj": "a070ef485a245988",
    "bunny.obj": "1e25437afc09c45f",
    "flames.obj": "f6a79e0fab0a83a1",
    "hall.obj": "d58a2a23cbd779c5",
    "pillars.obj": "efdc746d0794d434",
    "rock_base.png": "382306d06c6ab09c",
    "rock_emissive.png": "1388d0fa1cfbaf07",
    "rock_mr.png": "3833a23d2a65b3bb",
    "rock_normal.png": "d0722acdae7dbdf0",
    "stone_base.png": "82135f4adf3f3950",
    "stone_mr.png": "a5d3188f4408a1cf",
    "stone_normal.png": "c991429ecce638aa",
}


def small_assets(assets: dict) -> dict:
    out = copy.deepcopy(assets)
    for name, spec in out.items():
        spec.update(SMALL.get(name, {}))
        if "res" in spec:
            spec["res"] = MAP_RES
    return out


def dungeon_bench(root, size, wavefront=None, small=True, name=NAME):
    """The benchmark's data under `root`, the dungeon configuration `name`
    at size x size (where `small`, its assets at SMALL's parameters and SPP
    samples a step, else its own; the wavefront batch on or off, or as the
    configuration has it): (manifest, its progressive cell)."""
    bench = os.path.join(root, "fsptbench")
    for d in ("configs", "traffic", "checks", "metrics", "generators"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(bench, d),
                        dirs_exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    path = os.path.join(bench, "configs", f"{name}.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["render"].update(width=size, height=size)
    if wavefront is not None:
        cfg["render"]["wavefront_batch"] = wavefront
    if small:
        cfg["assets"] = small_assets(cfg["assets"])
        cfg["render"]["batch_spp"] = SPP
    with open(path, "w") as f:
        json.dump(cfg, f)
    return (Manifest(os.path.join(root, "BENCHMARK.json"), bench),
            f"{name}.progressive")


def light_weight_one(mp):
    """The program's fault: its light term's MIS weight forced to 1 (the
    call of brdf.mis_weights that weighs `pdf_l`), while an emitter that a
    path hits keeps its own weight."""
    real = brdf.mis_weights

    def mis_weights(a, b, *args, **kw):
        if a is sys._getframe(1).f_locals.get("pdf_l"):
            return torch.ones_like(a), torch.zeros_like(a)
        return real(a, b, *args, **kw)
    mp.setattr(brdf, "mis_weights", mis_weights)


def normal_map_ignored(mp):
    """The program's fault: the normal map's fetch replaced by the flat
    [0.5, 0.5, 1] of a prop without one."""
    real = integrator.atlas_fetch_all

    def atlas_fetch_all(*a, **kw):
        diffuse, emissive, tn, mr = real(*a, **kw)
        flat = V3(torch.full_like(tn.x, 0.5), torch.full_like(tn.y, 0.5),
                  torch.ones_like(tn.z))
        return diffuse, emissive, flat, mr
    mp.setattr(integrator, "atlas_fetch_all", atlas_fetch_all)


def digest(x) -> str:
    if isinstance(x, str):
        b = x.encode()
    else:
        a = np.ascontiguousarray(np.asarray(x))
        b = f"{a.dtype.str}{a.shape}".encode() + a.tobytes()
    return hashlib.sha256(b).hexdigest()[:16]


@pytest.fixture(scope="module")
def small():
    """The small configuration: its file's dict, its assets and its scene
    as the program loads it."""
    c = Manifest().config(NAME)
    assets = Assets(small_assets(c["assets"]))
    return c, assets, load_scene_dict(c["scene"], assets, name=NAME,
                                      **c["loader"])


def _cfg(c, **kw) -> RenderConfig:
    render = dict(c["render"], width=32, height=32, batch_spp=SPP,
                  seed=SEED)
    render.update(kw)
    render["compact_schedule"] = tuple(render["compact_schedule"])
    return RenderConfig(**render)


def _program(scene, cfg):
    """A renderer after its step IDX, and the step's summed radiance (n,
    3), as the harness keeps a window step."""
    r = Renderer(scene, cfg, device="cpu")
    r.sample_idx = IDX
    before = r.accum.double()
    r.step()
    return r, (r.accum.double() - before).T.numpy()


@pytest.fixture(scope="module")
def reference(small):
    """{wavefront: the plain reference's radiance of step IDX}, and the
    bfloat16 control's with the batch."""
    c, assets, _ = small
    scene = compile_scene(c["scene"], assets, "cpu")
    out = {}
    for wavefront, lowp in ((True, False), (False, False), (True, True)):
        cfg = config(dict(c["render"], width=32, height=32, batch_spp=SPP,
                          wavefront_batch=wavefront), SEED)
        out[wavefront, lowp] = Reference(scene, cfg, lowp=lowp).step(
            scene.camera, (32, 32), SEED, IDX, SPP).numpy()
    return out


@pytest.fixture(scope="module")
def stepped(small):
    c, _, scene = small
    return _program(scene, _cfg(c))


def _correct(prog, ref) -> bool:
    verdict = checks.judge(checks.radiance_numbers(prog, ref),
                           Manifest().limits(CELL))
    return all(v["ok"] for v in verdict.values())


# ---- the harness's comparison ---------------------------------------------

def test_cell_runs_correct_through_the_harness(tmp_path):
    m, cell = dungeon_bench(str(tmp_path), 32)
    r = run_cell(cell, SEED, 0.3, False, "cpu", m)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("wavefront", [True, False],
                         ids=["wavefront", "per_sample"])
def test_program_agrees_with_reference(small, reference, stepped,
                                       wavefront):
    c, _, scene = small
    prog = (stepped[1] if wavefront else
            _program(scene, _cfg(c, wavefront_batch=False))[1])
    assert _correct(prog, reference[wavefront, False])


@pytest.mark.parametrize("fault", [light_weight_one, normal_map_ignored],
                         ids=["light_weight_one", "normal_map_ignored"])
def test_faults_are_not_correct(small, reference, monkeypatch, fault):
    c, _, scene = small
    fault(monkeypatch)
    assert not _correct(_program(scene, _cfg(c))[1],
                        reference[True, False])


def test_control_is_rejected(reference):
    assert not _correct(reference[True, True], reference[True, False])


# ---- the generators -------------------------------------------------------

def test_generators_are_pinned_and_import_no_program():
    c = Manifest().config(NAME)
    got = {k: digest(v)
           for k, v in Assets(small_assets(c["assets"])).items.items()}
    assert got == DIGESTS
    bad = importcheck.violations()
    assert not [b for b in bad if b.startswith("generators")], bad


def test_full_meshes_hold_the_stated_triangles():
    """The configuration's own meshes: ~400,000 triangles, 2,560 of them
    the flames' (the area lights), the boulders and the statue clear of
    the floor's highest point."""
    c = Manifest().config(NAME)
    meshes = Assets({k: v for k, v in c["assets"].items()
                     if k.endswith(".obj")}).items
    tris = {k: t.count("\nf ") for k, t in meshes.items()}
    assert tris == {"hall.obj": 260_896, "pillars.obj": 32_768,
                    "boulders.obj": 81_920, "flames.obj": 2_560,
                    "bunny.obj": 20_480}
    lights = [p for p in c["scene"]["props"] if sum(p.get("emittance", []))]
    assert [p["path"] for p in lights] == ["flames.obj"]

    def verts(name):
        return np.asarray([line.split()[1:4]
                           for line in meshes[name].splitlines()
                           if line.startswith("v ")], np.float64)
    hall = verts("hall.obj")
    # the floor: the hall's vertices near y = 0 between its end walls
    floor_top = hall[(hall[:, 1] < 0.05) & (np.abs(hall[:, 2]) < 5.9), 1].max()
    statue, = [p for p in c["scene"]["props"] if p["path"] == "bunny.obj"]
    assert verts("boulders.obj")[:, 1].min() >= floor_top + 0.01
    assert (statue["translate"][1] - statue["scale"]
            >= floor_top + 0.01)
    assert meshes["hall.obj"].count("\nvt ") > 0


# ---- the program's counts and spans ---------------------------------------

def _rays(scene, cfg, key):
    n = cfg.width * cfg.height
    cam = scene.camera
    return generate_rays(torch.tensor(cam.position),
                         torch.tensor(cam.direction), cam.fov_scale,
                         cam.focal_depth, cam.aperture,
                         (cfg.width, cfg.height),
                         rng.stream_uniforms(key, 0, (4, n)))


def test_light_and_env_shadow_lanes_make_shadow(small):
    """Light NEE leaves every path as it was, so the env shadow lanes are
    those of the same trace without it: light plus them is shadow."""
    c, _, scene = small
    cfg = _cfg(c)
    arrays = scene.to_torch("cpu")
    key = rng.fold_in(rng.sample_key(rng.key(SEED), 3), 0)
    o, d = _rays(scene, cfg, key)
    off = dataclasses.replace(cfg, use_light_nee=False)
    with torch.no_grad():
        _, lit = integrator.trace_paths(arrays, cfg, scene.meta, o, d, key,
                                        return_stats=True,
                                        count_refracted=True)
        _, env = integrator.trace_paths(arrays, off, scene.meta, o, d, key,
                                        return_stats=True)
    assert torch.equal(lit.active, env.active)
    assert torch.equal(lit.light + env.shadow, lit.shadow)
    assert float(lit.light.sum()) > 0
    # the statue refracts; a trace not asked to count does not
    assert float(lit.refracted.sum()) > 0
    assert env.light is None and env.refracted is None


def test_renderer_counts_light_rays(small, stepped):
    c, _, scene = small
    cfg = _cfg(c)
    r = stepped[0]
    s = r.stats
    assert r.rays.shape == (2,)
    assert 0 < s["light_rays"] < s["rays"]
    assert (s["rays"], s["light_rays"]) == tuple(r.rays.tolist())
    m = r.step_metrics()
    assert len(m["light_occupancy"]) == len(m["refracted_occupancy"]) \
        == cfg.max_iters
    assert max(m["light_occupancy"]) > 0 and max(m["refracted_occupancy"]) > 0
    # without light NEE the count stays the 0-d tensor it was
    off = Renderer(scene, dataclasses.replace(cfg, use_light_nee=False),
                   device="cpu")
    assert off.rays.shape == () and off.stats["light_rays"] == 0.0


def test_new_spans_open_in_an_eager_step(small, stepped, tmp_path):
    c, _, scene = small
    plain = stepped[0]
    r = Renderer(scene, _cfg(c), device="cpu")
    r.sample_idx = IDX
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.step()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    for name in ("tables", "atlas", "light"):
        assert trace.PREFIX + name in names, name
    # one table build a trace (the wavefront batch traces once a step);
    # an atlas fetch and two light blocks a bounce
    assert names.count("fspt.tables") == 1
    assert names.count("fspt.light") == 2 * names.count("fspt.shade")
    assert names.count("fspt.atlas") == names.count("fspt.shade")
    for f in ("accum", "count", "rays"):
        assert torch.equal(getattr(r, f), getattr(plain, f)), f
