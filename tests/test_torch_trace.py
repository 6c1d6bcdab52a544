"""The port's phase spans (fspt_tpu_torch/trace.py) and the benchmark's
readers of them (fsptbench/spans.py, fsptbench/metrics/span_ms.*.py), on
the CPU.

One Renderer.step under torch.profiler (CPU activity) in the two
deployments the benchmark runs, cut to 32x32 and to 64x64 (the batched
one there with a merge width at which the wavefront batch runs both its
phases and compacts in each; the other compacts once a sample): the Chrome
trace holds one fspt.step, a fspt.traverse a
traversal launch, a fspt.shade and a fspt.uniforms a bounce iteration, a
fspt.sort an iteration under sort_state and a fspt.compact a compaction,
all inside the step; the step's numbers do not move with the profiler on.
One train step holds one forward and one backward span, in that order.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fspt_tpu_torch import trace
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator, rng
from fspt_tpu_torch.parallel.dist import (make_train_step, params_to_torch,
                                          split_params)
from fspt_tpu_torch.runtime.renderer import CameraState, Renderer
from fspt_tpu_torch.scene.schema import scene_to_torch
from fspt_tpu_torch.testing import make_test_scene
from fsptbench import profiling, spans
from fsptbench.manifest import Manifest

torch.set_num_threads(1)

PROGRESSIVE = ("span_ms.shade", "span_ms.uniforms", "span_ms.sort",
               "span_ms.compact", "span_ms.traverse", "span_ms.step_self")
UNREAD = ("tables", "atlas", "light")

# (benchmark configuration, size, batch_spp, wavefront_merge_width or None
# for the configuration's own)
CASES = {"bunny8_main": ("bunny8_main", 32, 2, None),
         "bunny4_cli": ("bunny4_cli", 32, 2, None),
         "bunny8_main_64": ("bunny8_main", 64, 2, 2048),
         "bunny4_cli_64": ("bunny4_cli", 64, 2, None)}


def _cfg(case) -> RenderConfig:
    name, size, spp, merge = CASES[case]
    render = dict(Manifest().config(name)["render"], width=size,
                  height=size, batch_spp=spp)
    render["compact_schedule"] = tuple(render["compact_schedule"])
    if merge is not None:
        render["wavefront_merge_width"] = merge
    return RenderConfig(**render)


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdivisions=2)


def _events(prof, tmp_path) -> list:
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events) -> list:
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(trace.PREFIX)]


def _named(events, name) -> list:
    return [e for e in _spans(events) if e["name"] == name]


@pytest.fixture(scope="module")
def stepped(scene, tmp_path_factory):
    """{case: (cfg, renderer, events, calls)}: one profiled Renderer.step
    (in a benchmark span, as the benchmark's slice has it), with the
    _bounce and _compact calls it made counted."""
    out = {}
    mp = pytest.MonkeyPatch()
    calls = {}
    for fn in ("_bounce", "_compact"):
        real = getattr(integrator, fn)

        def counted(*a, _real=real, _fn=fn, **kw):
            calls[_fn] += 1
            return _real(*a, **kw)
        mp.setattr(integrator, fn, counted)
    try:
        for case in CASES:
            cfg = _cfg(case)
            r = Renderer(scene, cfg, device="cpu")
            calls.update(_bounce=0, _compact=0)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with profiling.span("Renderer.step"):
                    r.step()
            out[case] = (cfg, r, _events(prof, tmp_path_factory.mktemp(case)),
                         dict(calls))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_step_spans_count_the_phases(stepped, case):
    cfg, _, events, calls = stepped[case]
    n = cfg.width * cfg.height
    step, = _named(events, "fspt.step")
    assert (len(_named(events, "fspt.traverse"))
            == integrator.traversal_launches(cfg, n, cfg.batch_spp))
    iters = calls["_bounce"]
    assert iters > 0
    assert len(_named(events, "fspt.shade")) == iters
    assert len(_named(events, "fspt.uniforms")) == iters
    assert len(_named(events, "fspt.sort")) == (iters if cfg.sort_state
                                                else 0)
    assert len(_named(events, "fspt.compact")) == calls["_compact"]
    # 32x32: only the batch's merged phase compacts, once
    assert calls["_compact"] == {"bunny8_main": 1, "bunny4_cli": 0,
                                 "bunny8_main_64": 4,
                                 "bunny4_cli_64": 2}[case]
    for e in _spans(events):
        assert step["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= step["ts"] + step["dur"]
    # a scatter launch a shading (no split shadow), inside it
    for sh in _named(events, "fspt.shade"):
        inner = [e for e in _named(events, "fspt.traverse")
                 if sh["ts"] <= e["ts"] <= sh["ts"] + sh["dur"]]
        assert len(inner) == 1


@pytest.mark.parametrize("case", list(CASES))
def test_profiler_does_not_move_the_step(scene, stepped, case):
    cfg, profiled, _, _ = stepped[case]
    r = Renderer(scene, cfg, device="cpu")
    r.step()
    assert torch.equal(r.accum, profiled.accum)
    assert torch.equal(r.count, profiled.count)
    assert torch.equal(r.rays, profiled.rays)


def test_span_records_only_under_a_profiler():
    assert trace.span("step") is trace.span("shade")     # no profiler: inert
    with profile(activities=[ProfilerActivity.CPU]):
        s = trace.span("step")
        assert isinstance(s, torch.profiler.record_function)
        assert s.name == "fspt.step"


def test_train_step_spans(scene, tmp_path):
    cfg = RenderConfig(width=16, height=1, bounces=2,
                       extra_refraction_iters=1, batch_spp=1,
                       intersector="brute")
    arrays = scene_to_torch(scene.arrays, "cpu")
    params = params_to_torch(
        {f: np.asarray(v) for f, v in split_params(scene.arrays).items()},
        "cpu")
    cam = CameraState.from_config(scene.camera, "cpu")
    cam_params = params_to_torch({"position": scene.camera.position,
                                  "direction": scene.camera.direction},
                                 "cpu")
    step = make_train_step(cfg, scene.meta, device="cpu")
    target = torch.zeros((3, 16), dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, cam_params, arrays, cam, target, rng.key(0), 1)
    events = _events(prof, tmp_path)
    fwd, = _named(events, "fspt.train.forward")
    bwd, = _named(events, "fspt.train.backward")
    assert bwd["ts"] >= fwd["ts"] + fwd["dur"]
    # the forward's trace holds its phases
    assert any(fwd["ts"] <= e["ts"] <= fwd["ts"] + fwd["dur"]
               for e in _named(events, "fspt.shade"))


def _run(summary, **work):
    return types.SimpleNamespace(slice=summary, slice_work=work, facts={},
                                 records=[])


@pytest.mark.parametrize("case", list(CASES))
def test_readers_partition_the_step(stepped, case):
    cfg, _, events, calls = stepped[case]
    summary = profiling.Summary(events)
    run = _run(summary, samples=cfg.batch_spp, steps=1)
    m = Manifest()
    got = {name: m.reader(name)(run) for name in PROGRESSIVE}
    # no span, no reading
    assert (got["span_ms.compact"] is None) == (calls["_compact"] == 0)
    got = {k: v for k, v in got.items() if v is not None}
    assert len(got) >= 5 and min(got.values()) >= 0, got
    step, = _named(events, "fspt.step")
    whole = step["dur"] * 1e-3 / cfg.batch_spp
    # the spans no reader reads (the table build in the step, the atlas
    # fetch and the light NEE in shading) hold the rest of it
    rest = sum(spans.total_s(summary, trace.PREFIX + name) or 0.0
               for name in UNREAD) * 1e3 / cfg.batch_spp
    assert rest > 0
    assert sum(got.values()) + rest == pytest.approx(whole, rel=1e-6)
    # shading's self time leaves its traversal launches out
    shade_whole = spans.total_s(summary, "fspt.shade", own=False)
    assert got["span_ms.shade"] < shade_whole * 1e3 / cfg.batch_spp
    # the train readers find nothing in a progressive step
    for name in ("span_ms.forward.train", "span_ms.backward.train"):
        assert m.reader(name)(run) is None


def _synthetic():
    # one benchmark span over two program steps (ms): step 0-10 holds
    # shade 1-6 (with traverse 2-3 and traverse 4-5.5) and compact 7-8;
    # step 12-20 holds shade 13-14; an aten op inside shade is no span;
    # a span on another thread is not the slice's
    ms = lambda x: x * 1e3
    ev = lambda name, a, b, tid=1, cat="user_annotation": {
        "cat": cat, "name": name, "ts": ms(a), "dur": ms(b - a), "tid": tid}
    return [ev("bench:Renderer.step", 0, 20),
            ev("fspt.step", 0, 10), ev("fspt.shade", 1, 6),
            ev("fspt.traverse", 2, 3), ev("aten::mul", 2.5, 5.0,
                                          cat="cpu_op"),
            ev("fspt.traverse", 4, 5.5), ev("fspt.compact", 7, 8),
            ev("fspt.step", 12, 20), ev("fspt.shade", 13, 14),
            ev("fspt.shade", 30, 40, tid=2)]


def test_readers_on_synthetic_spans():
    summary = profiling.Summary(_synthetic())
    found = spans.spans(summary)
    assert [n for n, _, _ in found] == [
        "fspt.step", "fspt.shade", "fspt.traverse", "fspt.traverse",
        "fspt.compact", "fspt.step", "fspt.shade"]
    assert [round(t * 1e3, 9) for t in spans.self_times(found)] == [
        10 - 5 - 1, 5 - 2.5, 1, 1.5, 1, 8 - 1, 1]
    assert spans.total_s(summary, "fspt.shade") == pytest.approx(3.5e-3)
    assert spans.total_s(summary, "fspt.shade", own=False) == \
        pytest.approx(6e-3)
    assert spans.total_s(summary, "fspt.sort") is None
    run = _run(summary, samples=4, steps=2)
    m = Manifest()
    assert m.reader("span_ms.shade")(run) == pytest.approx(3.5 / 4)
    assert m.reader("span_ms.traverse")(run) == pytest.approx(2.5 / 4)
    assert m.reader("span_ms.step_self")(run) == pytest.approx(11 / 4)
    assert m.reader("span_ms.compact")(run) == pytest.approx(1 / 4)
    assert m.reader("span_ms.sort")(run) is None


def test_self_time_clips_a_child_rounded_past_its_parent():
    found = [("fspt.step", 0.0, 1.0), ("fspt.shade", 0.5, 1.0 + 1e-12),
             ("fspt.step", 1.0 + 1e-12, 2.0)]
    assert spans.self_times(found) == pytest.approx([0.5, 0.5 + 1e-12, 1.0])


def test_readers_find_nothing_without_spans():
    m = Manifest()
    bare = profiling.Summary([{"cat": "user_annotation",
                               "name": "bench:train_step", "ts": 0.0,
                               "dur": 1e3, "tid": 1}])
    for name in PROGRESSIVE + ("span_ms.forward.train",
                               "span_ms.backward.train"):
        assert m.reader(name)(_run(None)) is None
        assert m.reader(name)(_run(bare, samples=8, steps=1)) is None
        assert m.reader(name)(_run(profiling.Summary(_synthetic()))) is None
