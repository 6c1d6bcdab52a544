"""The dungeon under the exact-replay estimator
(fsptbench/configs/dungeon8_exact.json: dungeon8_lit's scene with the CLI's
`--no-compact` switches) on the CPU, at 32x32 and 2 samples a step on
tests/test_torch_dungeon.py's small assets.  The harness's run takes the
configuration's 12 iterations; the other cases cut it to CUT's 4, as the
walk's plain version costs about half a second a launch there.

The harness runs its cell correct, and the program's step agrees with the
plain reference under the cell's limits; the program with its launches'
hits left in sorted order (the un-permute skipped), with its light term's
MIS weight forced to 1, or with nearest env lookups in place of bilinear
ones, is not, and the bfloat16 control is rejected.  The configuration's
render sets the five switches the CLI sets under `--no-compact`.  The
traversal ops count the lanes handed to each launch: an uncompacted step
launches exactly what its static shapes give, a compacted one the sum of
its launch widths, fewer.  `fspt.raysort` opens once a sorted launch, with
that launch's `fspt.traverse` inside, and the step's numbers do not move
with the profiler on.

On a card (`cuda` marker), at 64x64: replayed steps bit-equal to eager
ones, and the lane counter's replays adding the capture's lanes."""

import json
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fspt_tpu_torch import load_scene_dict
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator
from fspt_tpu_torch.ops.traverse import PacketHit, error_flag
from fspt_tpu_torch.ops.traverse3 import packet_traverse3
from fspt_tpu_torch.runtime.renderer import Renderer, sample_step
from fsptbench import checks
from fsptbench.manifest import Manifest
from fsptbench.reference.render import Reference, config
from fsptbench.reference.scene import compile_scene
from fsptbench.run import run_cell
from fsptbench.scenegen import Assets
from test_torch_dungeon import (IDX, SEED, SPP, dungeon_bench,
                                light_weight_one, small_assets)

torch.set_num_threads(1)

NAME = "dungeon8_exact"
CELL = "dungeon8_exact.progressive"
LIT = "dungeon8_lit"
# what fspt_tpu_torch/__main__.py _config switches under --no-compact
SWITCHES = ("compact", "sort_state", "intersector", "nee_env_nearest",
            "escape_env_nearest")
# the iterations cut from 12 to 4 (4 launches a sample instead of 13)
CUT = dict(bounces=2, extra_refraction_iters=2)


def unpermute_skipped(mp):
    """The program's fault: a sorted launch's hits handed back in the
    launch's sorted order, sorted_intersect's un-permute skipped."""
    real_intersect, real_sorted = (integrator.intersect,
                                   integrator.sorted_intersect)
    seen = {}

    def intersect(*a, **kw):
        seen["perm"] = sys._getframe(1).f_locals.get("perm")
        return real_intersect(*a, **kw)

    def sorted_intersect(*a, **kw):
        seen["perm"] = None
        hit = real_sorted(*a, **kw)
        perm = seen["perm"]
        return hit if perm is None else PacketHit(*(x[perm] for x in hit))
    mp.setattr(integrator, "intersect", intersect)
    mp.setattr(integrator, "sorted_intersect", sorted_intersect)


@pytest.fixture(scope="module")
def small():
    """The configuration's dict and its scene on the small assets."""
    c = Manifest().config(NAME)
    assets = Assets(small_assets(c["assets"]))
    return c, load_scene_dict(c["scene"], assets, name=NAME, **c["loader"])


def _cfg(c, size=32, **kw) -> RenderConfig:
    render = dict(c["render"], width=size, height=size, batch_spp=SPP,
                  seed=SEED, **CUT)
    render.update(kw)
    render["compact_schedule"] = tuple(render["compact_schedule"])
    return RenderConfig(**render)


def _program(scene, cfg):
    """A renderer after its step IDX, and the step's summed radiance."""
    r = Renderer(scene, cfg, device="cpu")
    r.sample_idx = IDX
    before = r.accum.double()
    r.step()
    return r, (r.accum.double() - before).T.numpy()


def _numbers(prog, ref) -> dict:
    return checks.judge(checks.radiance_numbers(prog, ref),
                        Manifest().limits(CELL))


def _correct(prog, ref) -> bool:
    return all(v["ok"] for v in _numbers(prog, ref).values())


@pytest.fixture(scope="module")
def reference(small):
    """{lowp: the plain reference's radiance of step IDX}."""
    c, _ = small
    scene = compile_scene(c["scene"], Assets(small_assets(c["assets"])),
                          "cpu")
    cfg = config(dict(c["render"], width=32, height=32, batch_spp=SPP,
                      **CUT), SEED)
    return {lowp: Reference(scene, cfg, lowp=lowp).step(
        scene.camera, (32, 32), SEED, IDX, SPP).numpy()
        for lowp in (False, True)}


def _events(prof, path) -> list:
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"]


def _widths(mp, name) -> list:
    """The widths of the traversal launches `integrator.<name>` makes."""
    widths = []
    real = getattr(integrator, name)

    def counted(nodes, leaves, origin, *a, **kw):
        widths.append(origin.x.shape[0])
        return real(nodes, leaves, origin, *a, **kw)
    mp.setattr(integrator, name, counted)
    return widths


@pytest.fixture(scope="module")
def stepped(small):
    """Step IDX: (renderer, radiance, the widths of its launches)."""
    c, scene = small
    mp = pytest.MonkeyPatch()
    try:
        widths = _widths(mp, "packet_traverse3")
        r, radiance = _program(scene, _cfg(c))
    finally:
        mp.undo()
    return r, radiance, widths


# ---- the configuration ----------------------------------------------------

def test_render_is_the_clis_no_compact(monkeypatch):
    """The file's render is dungeon8_lit's with the five switches the CLI
    sets under --no-compact, and the wavefront batch off."""
    import fspt_tpu_torch.__main__ as cli
    seen = []
    monkeypatch.setattr(cli, "cmd_render", lambda args: seen.append(args))
    cli.main(["render", "scene.json", "--no-compact"])
    args, = seen
    want = cli._config(args)
    render = Manifest().config(NAME)["render"]
    assert {k: render[k] for k in SWITCHES} == {
        k: getattr(want, k) for k in SWITCHES}
    lit = Manifest().config(LIT)["render"]
    assert {k for k in render if render[k] != lit[k]} == (
        set(SWITCHES) | {"wavefront_batch"})
    assert render["wavefront_batch"] is False
    cfg = RenderConfig(**dict(render, compact_schedule=tuple(
        render["compact_schedule"])))
    assert cfg.max_iters == 12 and cfg.use_light_nee and cfg.sort_rays


# ---- the harness's comparison ---------------------------------------------

def test_cell_runs_correct_through_the_harness(tmp_path):
    m, cell = dungeon_bench(str(tmp_path), 32, name=NAME)
    assert cell == CELL
    r = run_cell(cell, SEED, 0.3, False, "cpu", m)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_program_agrees_with_reference(reference, stepped):
    assert _correct(stepped[1], reference[False])


@pytest.mark.parametrize("fault", [unpermute_skipped, light_weight_one],
                         ids=["unpermute_skipped", "light_weight_one"])
def test_faults_are_not_correct(small, reference, monkeypatch, fault):
    c, scene = small
    fault(monkeypatch)
    assert not _correct(_program(scene, _cfg(c))[1], reference[False])


def test_nearest_env_reads_above_the_sound_step(small, reference, stepped):
    """Nearest env lookups in place of bilinear ones: the env is seen only
    through the vault's opening, so the cell's limits need not refuse it
    (a reading, PERF.md §2); it reads further from the reference than the
    sound step does."""
    c, scene = small
    _, prog = _program(scene, _cfg(c, nee_env_nearest=True,
                                   escape_env_nearest=True))
    fault = checks.radiance_numbers(prog, reference[False])
    sound = checks.radiance_numbers(stepped[1], reference[False])
    print("nearest env:", fault, "sound:", sound)
    assert fault["rel_l1"] > sound["rel_l1"]


def test_control_is_rejected(reference):
    assert not _correct(reference[True], reference[False])


# ---- the lanes launched ---------------------------------------------------

def test_uncompacted_step_launches_its_static_shapes(stepped):
    """Per sample, the primary launch's n rows, then each iteration one
    merged launch of n rows a segment: scatter, env shadow, light
    shadow."""
    r, _, widths = stepped
    cfg = r.cfg
    n = cfg.width * cfg.height
    want = SPP * (n + cfg.max_iters * 3 * n)
    assert r.stats["lanes_launched"] == sum(widths) == want
    assert r.stats["lanes_launched"] == r.stats["lane_rays_upper_bound"]
    assert 0 < r.stats["rays"] < want


def test_compacted_step_launches_its_widths(monkeypatch):
    """dungeon8_lit compacts: its step launches the sum of its launch
    widths, fewer lanes than the uncompacted step's static shapes."""
    c = Manifest().config(LIT)
    scene = load_scene_dict(c["scene"], Assets(small_assets(c["assets"])),
                            name=LIT, **c["loader"])
    widths = _widths(monkeypatch, "packet_traverse4")
    r, _ = _program(scene, _cfg(c))
    assert r.stats["lanes_launched"] == sum(widths)
    assert r.stats["lanes_launched"] < r.stats["lane_rays_upper_bound"]
    assert r.stats["rays"] <= r.stats["lanes_launched"]


# ---- the span -------------------------------------------------------------

def test_raysort_span_wraps_each_sorted_launch(small, tmp_path):
    """Every launch but the samples' primary ones is sorted: one
    fspt.raysort each, holding that launch's fspt.traverse; the step's
    numbers are those of the step without the profiler (one iteration,
    as the profiler's cost grows with the plain walk's many ops)."""
    c, scene = small
    cfg = _cfg(c, bounces=1, extra_refraction_iters=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r, _ = _program(scene, cfg)
    events = _events(prof, str(tmp_path / "trace.json"))
    named = lambda name: [e for e in events if e["name"] == name]
    sorts, launches = named("fspt.raysort"), named("fspt.traverse")
    assert len(launches) == SPP * (1 + cfg.max_iters)
    assert len(sorts) == SPP * cfg.max_iters
    for s in sorts:
        inner = [e for e in launches if s["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= s["ts"] + s["dur"]]
        assert len(inner) == 1
    plain, _ = _program(scene, cfg)
    for f in ("accum", "count", "rays"):
        assert torch.equal(getattr(r, f), getattr(plain, f)), f
    assert r.stats["lanes_launched"] == plain.stats["lanes_launched"]


# ---- on a card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eager(r: Renderer, num_batches: int = 1):
    for _ in range(num_batches):
        r.accum, r.count, r.rays = sample_step(
            r.arrays, r.cfg, r.scene.meta, r.camera, r.accum, r.count,
            r.rays, r.base_key, r.sample_idx, r.resolution, r.pixel_idx)
        r.sample_idx += 1
    r._sync()
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("num_batches", [1, 3])
def test_exact_graphed_step_matches_eager_on_card(cuda_device, small,
                                                  num_batches):
    """The exact-replay step captured and replayed on the small dungeon
    at 64x64 with light NEE, bit-equal to eager steps; every step, eager
    or replayed, launches its static shapes' lanes."""
    c, scene = small
    cfg = _cfg(c, 64)
    g, e = (Renderer(scene, cfg, device="cuda") for _ in range(2))
    n = cfg.width * cfg.height
    per_batch = cfg.batch_spp * (n + cfg.max_iters * 3 * n)
    for step in range(4):
        before = g.stats["lanes_launched"]
        g.step(num_batches)
        _eager(e, num_batches)
        for f in ("accum", "count", "rays"):
            assert torch.equal(getattr(g, f), getattr(e, f)), (step, f)
        assert g.stats["lanes_launched"] - before == num_batches * per_batch
    assert g.stats["graph_captures"] == 1
    assert g.stats["graph_replays"] == 3 * num_batches
    assert not error_flag(cuda_device).any()


@pytest.mark.cuda
def test_replays_add_the_captured_lanes_on_card(cuda_device, small):
    """A capture counts its lanes in `lanes_captured`, not `lanes`; each
    replay adds the capture's to `lanes`."""
    c, scene = small
    cfg = _cfg(c, 64)
    r = Renderer(scene, cfg, device="cuda")
    r.step()
    launches = packet_traverse3.lanes
    captured = packet_traverse3.lanes_captured
    r.warm_up()
    assert packet_traverse3.lanes == launches
    per_batch = packet_traverse3.lanes_captured - captured
    n = cfg.width * cfg.height
    assert per_batch == cfg.batch_spp * (n + cfg.max_iters * 3 * n)
    assert r._graph.lanes[1] == per_batch
    r.step(2)
    assert packet_traverse3.lanes - launches == 2 * per_batch
    assert packet_traverse3.lanes_captured - captured == per_batch
    assert r.stats["graph_replays"] == 2
