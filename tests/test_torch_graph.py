"""The sample step as a CUDA graph (runtime/renderer.py StepGraph).

On the CPU: keys read from a device row or table draw the same numbers as
host keys; the body the graph captures, traced eagerly from its static key
table and its camera and scene copies, equals `sample_step` bit for bit in
the two deployments the benchmark runs (the wavefront batch and the
per-sample path), over consecutive sample batches and across a camera
change; the scene's tables, built once a capture and read by the body,
rebuilt in place after a refit swap or an env change (and not after a
camera change), the body still bit-equal to `sample_step`; the
copy/recapture decision; and Renderer.step's replay path with the graph
stood in for by the body (what a card's replay runs), against eager
steps: when a step captures (not before enough batches follow to repay
it), Renderer.render as one step call, and warm_up.

On a card (`cuda` marker): Renderer.step replaying its graph against eager
`sample_step` calls, bit for bit, in both deployments at a reduced size,
with one and three batches a step, after a camera change, an arrays swap
by refit (with and without light NEE), reset() and load_checkpoint(); a
stack overflow still raises after a replay; a replayed step counts its
traversal launches, a capture none; a replayed step builds no scene
tables, a capture and a scene refresh one each; the viewer captures both
renderers before it serves events.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fspt_tpu_torch import trace
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator, rng
from fspt_tpu_torch.core.integrator import scene_tables, traversal_launches
from fspt_tpu_torch.ops.traverse import error_flag
from fspt_tpu_torch.ops.traverse4 import packet_traverse4
from fspt_tpu_torch.runtime import renderer
from fspt_tpu_torch.runtime.renderer import (CAPTURE_AHEAD, Renderer,
                                             StepGraph, refresh_inputs,
                                             sample_step)
from fspt_tpu_torch.testing import make_test_scene
from fsptbench.manifest import Manifest

torch.set_num_threads(1)

# (benchmark configuration, size, batch_spp, wavefront_merge_width or None
# for the configuration's own): at 64x64 with a merge width of 2048 the
# wavefront batch runs its per-sample phase, compacting with each sample's
# key, and its merged phase, with the key table; the per-sample path
# compacts there too
CASES = {"bunny8_main": ("bunny8_main", 64, 2, 2048),
         "bunny4_cli": ("bunny4_cli", 64, 2, None)}


def _cfg(case, **kw) -> RenderConfig:
    name, size, spp, merge = CASES[case]
    render = dict(Manifest().config(name)["render"], width=size,
                  height=size, batch_spp=spp)
    render["compact_schedule"] = tuple(render["compact_schedule"])
    if merge is not None:
        render["wavefront_merge_width"] = merge
    render.update(kw)
    return RenderConfig(**render)


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdivisions=2)


def _eager(r: Renderer, num_batches: int = 1):
    """r advanced by `num_batches` eager sample_step calls, as Renderer.step
    runs them before any capture."""
    for _ in range(num_batches):
        r.accum, r.count, r.rays = sample_step(
            r.arrays, r.cfg, r.scene.meta, r.camera, r.accum, r.count,
            r.rays, r.base_key, r.sample_idx, r.resolution, r.pixel_idx)
        r.sample_idx += 1
    r._sync()
    return r


def _same(a: Renderer, b: Renderer):
    for f in ("accum", "count", "rays"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.sample_idx == b.sample_idx


def _moved(cam):
    return cam._replace(position=cam.position + torch.tensor(
        [0.05, -0.02, 0.1], device=cam.position.device))


def _refit_scene(translate, angle=0.0, lit=False):
    """A floor and a sphere that refit moves (and, lit, a fixed emissive
    lamp for light NEE): (scene dict, Scene)."""
    from fspt_tpu_torch.scene.schema import load_scene_dict
    from fspt_tpu_torch.testing import (DictAssetLoader, icosphere_obj,
                                        quad_obj)
    sd = {"environment": [[0.2, 0.2, 0.3], [0.8, 0.9, 1.0]],
          "cameraPos": [0.0, 0.4, 2.2], "cameraDir": [0.0, -0.18, -0.98],
          "samples": 8,
          "props": [{"path": "floor.obj", "scale": 6.0,
                     "translate": [0, -0.5, 0], "diffuse": [0.6, 0.6, 0.6],
                     "metallicRoughness": [0.0, 0.6, 0.0],
                     "normals": "flat"}],
          "animated_props": [{"path": "sphere.obj", "scale": 0.4,
                              "translate": translate,
                              "rotate": [{"axis": [0, 1, 0],
                                          "angle": angle}],
                              "diffuse": [0.9, 0.4, 0.3],
                              "metallicRoughness": [0.0, 0.3, 0.0],
                              "normals": "smooth"}]}
    if lit:
        sd["props"].append({"path": "lamp.obj", "scale": 0.15,
                            "translate": [0.8, 0.9, -0.4],
                            "diffuse": [1.0, 1.0, 1.0],
                            "emittance": [6.0, 5.0, 4.0],
                            "metallicRoughness": [0.0, 1.0, 0.0],
                            "normals": "flat"})
    loader = DictAssetLoader(texts={"sphere.obj": icosphere_obj(2),
                                    "floor.obj": quad_obj(),
                                    "lamp.obj": icosphere_obj(1)})
    return sd, load_scene_dict(sd, loader)


def _refitted(arrays, base_sd, base, lit=False):
    """`arrays` with the sphere of _refit_scene moved and turned by refit:
    the same shapes, other triangles, boxes and shading frames."""
    from fspt_tpu_torch.scene.refit import (aux_to, build_refit_aux,
                                            delta_affines, refit_arrays)
    from fspt_tpu_torch.scene.schema import (_prop_defaults,
                                             merge_scene_props)
    moved_sd, _ = _refit_scene([0.35, 0.15, -0.2], angle=0.8, lit=lit)
    aux = aux_to(build_refit_aux(base), arrays.pk_nodes.device)
    mats, trans = delta_affines(
        [_prop_defaults(p) for p in merge_scene_props(base_sd)],
        [_prop_defaults(p) for p in merge_scene_props(moved_sd)])
    return refit_arrays(arrays, base.meta, aux, mats, trans)


# ---- keys as device data ---------------------------------------------------

@pytest.mark.parametrize("lanes", ["offset", "ids"])
@pytest.mark.parametrize("rows", [False, True])
def test_stream_uniforms_device_key_row_bit_equal(lanes, rows):
    """A (2,) int64 key row (and a (K, 2) table as key_rows) draws the host
    key's numbers exactly."""
    key = rng.fold_in(rng.sample_key(rng.key(3_123_456_789), 41), 2)
    row = torch.from_numpy(key.astype(np.int64))
    offset = (torch.arange(700, dtype=torch.int32) * 3 if lanes == "ids"
              else 129)
    kw = {}
    if rows:
        table = rng.key_rows_for(key, 4)
        kw = dict(key_rows=rng.key_rows_tensor(table, "cpu"),
                  lanes_per_key=1024)
        row_kw = dict(key_rows=torch.from_numpy(table.astype(np.int64)),
                      lanes_per_key=1024)
    else:
        row_kw = {}
    want = rng.stream_uniforms(key, 5, (11, 700), lane_offset=offset, **kw)
    got = rng.stream_uniforms(row, 5, (11, 700), lane_offset=offset,
                              **row_kw)
    assert torch.equal(got, want)


# ---- the body the graph captures --------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_graph_body_matches_sample_step(scene, body_graphs, case):
    """StepGraph's body, from its key table and its camera and scene
    copies, accumulated as a replay is: bit-equal to sample_step over two
    consecutive batches and, after a camera change taken by the copy path,
    a third."""
    cfg = _cfg(case)
    r = Renderer(scene, cfg, device="cpu")
    g = StepGraph(r)
    acc, count, rays = r.accum, r.count, r.rays
    for idx in range(3):
        if idx == 2:
            r.camera = _moved(r.camera)
            assert g.holds(r)
            assert torch.equal(g.camera.position, r.camera.position)
            assert g.camera.position is not r.camera.position
        want = sample_step(r.arrays, cfg, r.scene.meta, r.camera, acc, count,
                           rays, r.base_key, idx, r.resolution, r.pixel_idx)
        g.set_keys(r.base_key, idx)
        radiance, ray_counts = g.run_body()
        assert len(radiance) == (1 if case == "bunny8_main"
                                 else cfg.batch_spp)
        got = renderer._accumulate(cfg, acc, count, rays, radiance,
                                   ray_counts)
        for w, x in zip(want, got):
            assert torch.equal(w, x)
        acc, count, rays = got
    assert float(count) == 3 * cfg.batch_spp
    assert float(rays) > 0


@pytest.mark.parametrize("case,lit", [("bunny8_main", False),
                                      ("bunny4_cli", False),
                                      ("bunny8_main", True)])
def test_graph_tables_follow_scene_swaps(body_graphs, case, lit):
    """The body reads the scene's tables built ahead from the graph's
    scene copies.  A capture builds them once; a camera change builds
    nothing; an arrays swap by refit (other triangles and shading frames)
    and an env_rgb change, each taken by the copy path, rebuild them once,
    in place; and the body stays bit-equal to sample_step throughout,
    building nothing itself."""
    base_sd, base = _refit_scene([0.0, 0.0, 0.0], lit=lit)
    cfg = _cfg(case, width=32, height=32, use_light_nee=lit)
    r = Renderer(base, cfg, device="cpu")
    builds = scene_tables.launches
    g = StepGraph(r)
    assert scene_tables.launches - builds == 1
    attr = g.tables.attr
    env6 = g.tables.tex.env6
    first = (attr.clone(), env6.clone())
    acc, count, rays = r.accum, r.count, r.rays
    for idx, change in enumerate(("camera", "refit", "env")):
        if change == "camera":
            r.camera = _moved(r.camera)
        elif change == "refit":
            r.arrays = _refitted(r.arrays, base_sd, base, lit=lit)
        else:
            r.arrays = r.arrays._replace(env_rgb=r.arrays.env_rgb * 1.5)
        builds = scene_tables.launches
        assert g.holds(r)
        assert scene_tables.launches - builds == (change != "camera")
        want = sample_step(r.arrays, cfg, r.scene.meta, r.camera, acc, count,
                           rays, r.base_key, idx, r.resolution, r.pixel_idx)
        builds = scene_tables.launches
        g.set_keys(r.base_key, idx)
        got = renderer._accumulate(cfg, acc, count, rays, *g.run_body())
        assert scene_tables.launches == builds
        for w, x in zip(want, got):
            assert torch.equal(w, x), change
        acc, count, rays = got
    # rebuilt into the storage the graph reads, with other values
    assert g.tables.attr is attr and g.tables.tex.env6 is env6
    assert not torch.equal(attr, first[0])
    assert not torch.equal(env6, first[1])
    if lit:
        assert float(rays[1]) > 0


# host reads and host-made tensors, which a CUDA graph cannot capture: a
# tensor made from host data (lift_fresh), a value read back, a boolean
# mask's gather or scatter (its size is read back)
_UNCAPTURABLE = ("aten.lift_fresh.", "aten._local_scalar_dense.",
                 "aten.nonzero.", "aten.masked_select.", "aten.item.")


class _HostReads(TorchDispatchMode):
    """The uncapturable ops dispatched while active, outside the traversal
    launches (a kernel on the card; their plain versions run here)."""

    def __init__(self):
        super().__init__()
        self.paused, self.found = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not self.paused:
            masked = (name.startswith(("aten.index.", "aten.index_put"))
                      and any(i is not None and i.dtype == torch.bool
                              for i in args[1]))
            if masked or name.startswith(_UNCAPTURABLE):
                self.found.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case,kw", [
    ("bunny8_main", {}), ("bunny4_cli", {}),
    ("bunny4_cli", dict(intersector="walk")),
    ("bunny4_cli", dict(intersector="packet")),
    ("bunny4_cli", dict(mode="bvh_heatmap")),
    ("bunny4_cli", dict(use_light_nee=True, split_shadow=False))])
def test_graph_body_reads_nothing_from_the_host(scene, body_graphs,
                                                monkeypatch, case,
                                                kw):
    """What a capture would refuse, found on the CPU: the body makes no
    tensor from host data and reads no value back."""
    mode = _HostReads()
    for name in ("packet_traverse4", "packet_traverse3", "packet_traverse"):
        real = getattr(integrator, name)

        def launch(*a, _real=real, **k):
            mode.paused += 1
            try:
                return _real(*a, **k)
            finally:
                mode.paused -= 1
        monkeypatch.setattr(integrator, name, launch)
    r = Renderer(scene, _cfg(case, width=32, height=32, **kw), device="cpu")
    g = StepGraph(r)
    g.set_keys(r.base_key, 0)
    with mode:
        radiance, _ = g.run_body()
    assert mode.found == []
    assert float(radiance[0].sum()) > 0


def test_key_table_rows(scene, body_graphs):
    cfg = _cfg("bunny8_main")
    r = Renderer(scene, cfg, device="cpu")
    g = StepGraph(r)
    g.set_keys(r.base_key, 7)
    key = rng.sample_key(r.base_key, 7)
    want = np.stack([rng.fold_in(key, i) for i in range(cfg.batch_spp)])
    np.testing.assert_array_equal(g.keys.numpy(), want.astype(np.int64))


# ---- copy or capture again --------------------------------------------------

def test_refresh_inputs_decides_copy_or_recapture():
    """refresh_inputs copies what is new and says whether it copied; None
    where the graph must be captured again."""
    a, b = torch.zeros(4), torch.ones(3, 2)
    static = [torch.zeros(4), torch.zeros(3, 2)]
    seen = [a, b]
    assert refresh_inputs(static, seen, [a, b]) is False  # nothing new
    assert torch.equal(static[1], torch.zeros(3, 2))     # nothing copied
    c = torch.full((4,), 2.0)
    assert refresh_inputs(static, seen, [c, b]) is True
    assert torch.equal(static[0], c) and seen[0] is c
    assert refresh_inputs(static, seen, [c, b]) is False
    assert refresh_inputs(static, seen, [c, torch.ones(2, 3)]) is None
    assert refresh_inputs(static, seen,
                          [torch.zeros(4, dtype=torch.float64), b]) is None
    assert refresh_inputs(static, seen, [1.0, b]) is None
    assert refresh_inputs(static, seen, [c]) is None


def test_arrays_swap_copies_same_shapes_and_refuses_others(scene,
                                                           body_graphs):
    cfg = _cfg("bunny4_cli", width=32, height=32)
    r = Renderer(scene, cfg, device="cpu")
    g = StepGraph(r)
    theta = torch.tensor(0.25, dtype=r.arrays.env_theta.dtype)
    r.arrays = r.arrays._replace(env_theta=theta)      # the viewer's slider
    assert g.holds(r)
    assert float(g.arrays.env_theta) == 0.25
    assert g.arrays.env_theta is not theta
    emit = r.arrays.emit._replace(x=r.arrays.emit.x * 2.0)
    r.arrays = r.arrays._replace(emit=emit)            # a V3 field
    assert g.holds(r)
    assert torch.equal(g.arrays.emit.x, emit.x)
    bigger = torch.cat([r.arrays.pk_nodes, r.arrays.pk_nodes[:1]])
    r.arrays = r.arrays._replace(pk_nodes=bigger)      # another tree
    assert not g.holds(r)
    r2 = Renderer(scene, cfg, device="cpu")
    g2 = StepGraph(r2)
    r2.cfg = dataclasses.replace(cfg, seed=8)          # another config
    assert not g2.holds(r2)


# ---- Renderer.step's replay path, the graph stood in for by its body ------

class _BodyGraph:
    """What a replay does, on the CPU: the captured body run again."""

    def __init__(self, g):
        self.g = g

    def replay(self):
        self.g.radiance, self.g.rays = self.g.run_body()


@pytest.fixture
def body_graphs(monkeypatch):
    captured = []

    def capture(self):
        self.graph = _BodyGraph(self)
        self.launches = self.lanes = (0, 0, 0)
        captured.append(self)
    monkeypatch.setattr(StepGraph, "_capture", capture)
    return captured


def test_cpu_renderer_never_captures(scene):
    r = Renderer(scene, _cfg("bunny4_cli", width=32, height=32),
                 device="cpu").step(2)
    assert r._graph is None
    assert r.stats["graph_captures"] == r.stats["graph_replays"] == 0


@pytest.mark.parametrize("case", list(CASES))
def test_replay_path_matches_eager(scene, body_graphs, case, tmp_path,
                                   monkeypatch):
    """Renderer.step through _replay (as on a card after its first batch):
    one capture for three batches, a `fspt.replay` span each, equal to
    eager steps after a camera change, an arrays swap of the same shapes,
    reset() and load_checkpoint(); a swap of another shape captures
    again."""
    cfg = _cfg(case, width=32, height=32)
    g, e = (Renderer(scene, cfg, device="cpu") for _ in range(2))
    g._graphs = True                   # as on a card
    g.step()
    _eager(e)
    names = []

    def span(name):
        names.append(name)
        return trace.span(name)
    monkeypatch.setattr(renderer, "span", span)
    g.step(3)
    _eager(e, 3)
    _same(g, e)
    assert names == ["step", "replay", "replay", "replay"]
    assert g.stats["graph_captures"] == 1
    assert g.stats["graph_replays"] == 3
    assert g.stats["rays"] == pytest.approx(float(e.rays))
    before = g.accum
    g.camera = e.camera = _moved(g.camera)
    theta = torch.tensor(0.5, dtype=g.arrays.env_theta.dtype)
    g.arrays = g.arrays._replace(env_theta=theta)
    e.arrays = e.arrays._replace(env_theta=theta)
    _same(g.step(), _eager(e))
    assert g.accum is not before       # a new tensor every step
    assert g.stats["graph_captures"] == 1
    g.reset()
    e.reset()
    _same(g.step(), _eager(e))
    path = str(tmp_path / "ckpt.npz")
    g.step().save_checkpoint(path)
    _eager(e)
    g.step()
    _eager(e)
    g.load_checkpoint(path)
    e.load_checkpoint(path)
    _same(g.step(), _eager(e))
    assert g.stats["graph_captures"] == 1
    g.arrays = g.arrays._replace(
        pk_nodes=torch.cat([g.arrays.pk_nodes, g.arrays.pk_nodes[:1]]))
    g.step()
    assert g.stats["graph_captures"] == 2
    assert len(body_graphs) == 2


@pytest.mark.parametrize("calls,replays", [
    ((CAPTURE_AHEAD + 1,), 0),                # too short to repay a capture
    ((CAPTURE_AHEAD + 2,), CAPTURE_AHEAD + 1),  # captured at its 2nd batch
    ((2, 1), 1),                              # a progressive loop's 2nd call
    ((1, 1, 2), 3)])
def test_capture_waits_until_it_pays(scene, body_graphs, calls, replays):
    """Renderer.step as on a card: the first batch eager; a capture in the
    first step call only with CAPTURE_AHEAD batches after it, in any later
    call at once; every step bit-equal to eager steps."""
    cfg = _cfg("bunny4_cli", width=16, height=16, batch_spp=1)
    g, e = (Renderer(scene, cfg, device="cpu") for _ in range(2))
    g._graphs = True
    for n in calls:
        _same(g.step(n), _eager(e, n))
    assert g.stats["graph_replays"] == replays
    assert g.stats["graph_captures"] == (replays > 0)


@pytest.mark.parametrize("samples,replays", [
    (2, 0), (CAPTURE_AHEAD + 2, CAPTURE_AHEAD + 1)])
def test_render_is_one_step_call(scene, body_graphs, samples, replays):
    """Renderer.render steps once for all its batches, so that a short
    one-shot render stays eager and a long one captures at its second
    batch."""
    cfg = _cfg("bunny4_cli", width=16, height=16, batch_spp=1)
    g, e = (Renderer(scene, cfg, device="cpu") for _ in range(2))
    g._graphs = True
    g.render(samples)
    _same(g, _eager(e, samples))
    assert g.stats["graph_replays"] == replays


def test_warm_up_captures_and_leaves_the_accumulation(scene, body_graphs):
    """warm_up (the viewer's, before it serves events): an eager batch and
    the capture, the accumulation untouched; the first step then replays,
    bit-equal to an eager one; nothing happens on the CPU."""
    cfg = _cfg("bunny8_main", width=16, height=16)
    cpu = Renderer(scene, cfg, device="cpu").warm_up()
    assert cpu._graph is None and cpu.stats["graph_captures"] == 0
    g, e = (Renderer(scene, cfg, device="cpu") for _ in range(2))
    g._graphs = True
    g.warm_up()
    assert g.stats["graph_captures"] == 1
    assert float(g.count) == 0.0 and g.sample_idx == 0
    assert not g.accum.any()
    g.warm_up()
    assert g.stats["graph_captures"] == 1
    _same(g.step(), _eager(e))
    _same(g.step(), _eager(e))
    assert g.stats["graph_replays"] == 2
    assert g.stats["graph_captures"] == 1


def test_graph_replays_per_step_reader():
    """fsptbench/metrics/graph_replays_per_step.py: the slice's fspt.replay
    spans over its steps; 0.0 for steps that replayed nothing; nothing to
    read without a slice."""
    read = Manifest().reader("graph_replays_per_step")
    host = [("fspt.step", 0.0, 1.0), ("fspt.replay", 0.1, 0.2),
            ("aten::add", 0.3, 0.4), ("fspt.step", 1.0, 2.0),
            ("fspt.replay", 1.1, 1.2), ("fspt.replay", 1.3, 1.4)]
    run = types.SimpleNamespace(slice=types.SimpleNamespace(host=host),
                                slice_work={"steps": 2, "samples": 16})
    assert read(run) == 1.5
    run.slice.host = [e for e in host if e[0] != "fspt.replay"]
    assert read(run) == 0.0
    run.slice = None
    assert read(run) is None


# ---- on a card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_cfg(case, size=128, **kw):
    name = CASES[case][0]
    render = dict(Manifest().config(name)["render"], width=size,
                  height=size)
    render["compact_schedule"] = tuple(render["compact_schedule"])
    render.update(kw)
    return RenderConfig(**render)


@pytest.fixture(scope="module")
def card_scene():
    return make_test_scene(subdivisions=3)


@pytest.mark.cuda
@pytest.mark.parametrize("num_batches", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_step_matches_eager_on_card(cuda_device, card_scene, case,
                                            num_batches):
    cfg = _card_cfg(case)
    g, e = (Renderer(card_scene, cfg, device="cuda") for _ in range(2))
    builds = []
    for step in range(4):
        packet_traverse4.launches = 0
        before = g.stats["table_builds"]
        g.step(num_batches)
        launches = packet_traverse4.launches
        builds.append(g.stats["table_builds"] - before)
        _eager(e, num_batches)
        _same(g, e)
        assert launches == num_batches * traversal_launches(
            cfg, cfg.width * cfg.height, cfg.batch_spp), step
    # eager traces build the scene's tables each, the capture once, a
    # replay never
    per_trace = 1 if case == "bunny8_main" else cfg.batch_spp
    assert builds == [num_batches * per_trace, 1, 0, 0]
    assert g.stats["graph_captures"] == 1
    # the first call runs eagerly (too few batches to repay a capture)
    assert g.stats["graph_replays"] == 3 * num_batches
    assert g.stats["rays"] == pytest.approx(float(e.rays), rel=1e-6)
    assert not error_flag(cuda_device).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(intersector="walk"),
                                dict(intersector="packet"),
                                dict(mode="bvh_heatmap")])
def test_graphed_step_other_paths_on_card(cuda_device, card_scene, kw):
    cfg = _card_cfg("bunny4_cli", 64, **kw)
    g, e = (Renderer(card_scene, cfg, device="cuda") for _ in range(2))
    g.step()
    g.step(2)
    _eager(e, 3)
    _same(g, e)
    assert g.stats["graph_replays"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case,lit", [
    pytest.param("bunny8_main", False, id="bunny8_main"),
    pytest.param("bunny4_cli", False, id="bunny4_cli"),
    pytest.param("bunny8_main", True, id="bunny8_main-light_nee")])
def test_graphed_step_follows_swaps_on_card(cuda_device, case, lit,
                                            tmp_path):
    """A camera change, an arrays swap by refit (same shapes: copied, not
    captured again), reset() and load_checkpoint(), each followed by
    replays bit-equal to eager steps; the capture builds the scene's
    tables once, the swap once more, and nothing else does."""
    base_sd, base = _refit_scene([0.0, 0.0, 0.0], lit=lit)
    cfg = _card_cfg(case, 64, use_light_nee=lit)
    g, e = (Renderer(base, cfg, device="cuda") for _ in range(2))
    g.step()
    built = g.stats["table_builds"]
    g.step()
    _eager(e, 2)
    _same(g, e)
    assert g.stats["table_builds"] - built == 1         # the capture's
    g.camera = e.camera = _moved(g.camera)
    _same(g.step(), _eager(e))
    assert g.stats["table_builds"] - built == 1
    g.arrays = e.arrays = _refitted(g.arrays, base_sd, base, lit=lit)
    g.reset()
    e.reset()
    _same(g.step(2), _eager(e, 2))
    assert g.stats["table_builds"] - built == 2         # the refresh's
    path = str(tmp_path / "ckpt.npz")
    g.save_checkpoint(path)
    g.step()
    _eager(e)
    g.load_checkpoint(path)
    e.load_checkpoint(path)
    _same(g.step(), _eager(e))
    assert g.stats["table_builds"] - built == 2
    assert g.stats["graph_captures"] == 1
    if lit:
        assert float(g.rays[1]) > 0


@pytest.mark.cuda
def test_stack_overflow_raises_after_replay(cuda_device, card_scene):
    """A stack too small for the tree: every step raises at its
    synchronise, the replays' too, and the flag is cleared each time."""
    meta = dataclasses.replace(card_scene.meta, pk_stack_depth=2)
    scene = dataclasses.replace(card_scene, meta=meta)
    r = Renderer(scene, _card_cfg("bunny4_cli", 64, intersector="walk",
                                  stack_depth=2), device="cuda")
    for _ in range(3):
        with pytest.raises(RuntimeError, match="overflowed"):
            r.step()
    assert r.stats["graph_replays"] == 2
    assert not error_flag(cuda_device).any()


@pytest.mark.cuda
def test_viewer_captures_before_it_serves_on_card(cuda_device, card_scene):
    """InteractiveViewer.start captures both renderers' graphs before the
    first event; a capture adds to the launch counter nothing, and its
    launches to `captured`; previews and settled frames then replay."""
    import time

    from fspt_tpu_torch.runtime.viewer import InteractiveViewer
    cfg = _card_cfg("bunny4_cli", 64)
    v = InteractiveViewer(card_scene, cfg, device="cuda")
    want = traversal_launches(cfg, cfg.width * cfg.height, cfg.batch_spp)
    packet_traverse4.launches = packet_traverse4.captured = 0
    v.renderer.warm_up()
    assert (packet_traverse4.launches, packet_traverse4.captured) == (want,
                                                                      want)
    v.start()
    try:
        assert v.preview.stats["graph_captures"] == 1
        deadline = time.perf_counter() + 60
        while v.preview.stats["graph_replays"] == 0:
            # a drag: look events until the loop serves a preview
            assert time.perf_counter() < deadline, "no preview"
            v.handle_event({"type": "look", "dx": 2, "dy": 1})
            time.sleep(0.05)
        while v.renderer.stats["graph_replays"] == 0:
            # released: the settled renderer's frames
            assert time.perf_counter() < deadline, "no full frame"
            time.sleep(0.05)
    finally:
        v.stop()
    for r in (v.renderer, v.preview):
        assert r.stats["graph_captures"] == 1
