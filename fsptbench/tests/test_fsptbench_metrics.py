"""The metrics' arithmetic on synthetic records and profiler events."""

import types

import pytest

from fsptbench import yardstick
from fsptbench.manifest import Manifest
from fsptbench.profiling import Summary, union


def _run(**kw):
    base = dict(records=[], facts={}, slice=None, slice_work={},
                window_s=0.0, setup_s=0.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, run):
    return Manifest().reader(name)(run)


def test_ms_per_sample_is_the_window_over_all_samples():
    # a stall in one step moves the window mean, not the median of steps
    recs = [{"t0": i * 0.1, "t1": i * 0.1 + 0.1, "samples": 8, "rays": 1}
            for i in range(9)] + [{"t0": 0.9, "t1": 2.0, "samples": 8,
                                   "rays": 1}]
    run = _run(records=recs, window_s=2.0)
    assert read("ms_per_sample", run) == pytest.approx(2000.0 / 80)
    assert read("step_ms_p50", run) == pytest.approx(100.0)


def test_frame_p95_nearest_rank_over_every_event():
    lat = [0.001 * (i + 1) for i in range(200)]
    run = _run(records=[{"latency_s": x} for x in reversed(lat)])
    # 95% of 200 is 190: the 190th smallest
    assert read("frame_ms_p95", run) == pytest.approx(190.0)
    assert yardstick.percentile([5.0], 95) == 5.0
    assert read("frame_ms_p95", _run()) is None


def test_union_and_idle_share():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]
    assert yardstick.idle_pct(1.0, 4.0) == pytest.approx(75.0)
    assert yardstick.idle_pct(1.0, 0.0) is None


def _events():
    # one benchmark span of 10 ms with three kernels (two overlap) and a
    # memcpy; a host op covers the gap between 4 and 8 ms
    us = lambda s: s * 1e6
    return [
        {"cat": "user_annotation", "name": "bench:Renderer.step",
         "ts": us(0.0), "dur": us(0.010), "tid": 1},
        {"cat": "cpu_op", "name": "aten::sort", "ts": us(0.004),
         "dur": us(0.004), "tid": 1},
        {"cat": "kernel", "name": "walk4_kernel", "ts": us(0.001),
         "dur": us(0.002), "tid": 7},
        {"cat": "kernel", "name": "elementwise", "ts": us(0.002),
         "dur": us(0.002), "tid": 7},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": us(0.008),
         "dur": us(0.001), "tid": 7},
        {"cat": "kernel", "name": "outside", "ts": us(0.5), "dur": 1.0,
         "tid": 7},
    ]


def test_summary_busy_gaps_and_kernels():
    s = Summary(_events())
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.004)          # 1-4 ms, 8-9 ms
    assert len(s.kernels) == 2
    assert s.kernel_s("walk4_kernel") == pytest.approx(0.002)
    gaps = s.top_gaps()
    assert gaps[0][0] == "Renderer.step > aten::sort"
    assert gaps[0][1] == pytest.approx(0.004)
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert s.top_ops()[0][0] in ("walk4_kernel", "elementwise")
    run = _run(slice=s, slice_work={"samples": 8, "steps": 1, "rays": 1e6},
               facts={"table_bytes": 10_000_000})
    assert read("device_idle_pct.render", run) == pytest.approx(60.0)
    assert read("device_ms_per_sample", run) == pytest.approx(0.5)
    assert read("kernels_per_sample", run) == pytest.approx(2 / 8)
    least = 1e6 * 48 + 10_000_000
    assert read("traverse4_roofline", run) == pytest.approx(
        least / 3.35e12 / 0.002 * 100)


def test_bytes_rule():
    # 7 f32 read and 5 words written a ray, the tables once a step
    assert yardstick.traversal_bytes(10, 2, 1000) == 10 * 48 + 2000
    assert yardstick.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert yardstick.roofline_pct(1.0, 0.0) is None


def test_readers_find_nothing_without_a_trace():
    for name in ("kernels_per_sample", "traverse4_roofline",
                 "device_idle_pct.render", "device_ms_per_sample",
                 "device_idle_pct.view", "frames_per_s.view"):
        assert read(name, _run()) is None


def test_viewer_frame_rate_leaves_out_the_profiled_slice():
    run = _run(facts={"frames_untraced": 90, "untraced_s": 45.0})
    assert read("frames_per_s.view", run) == pytest.approx(2.0)
    run = _run(records=[{"t0": 0.0, "t1": 0.5}] * 4, window_s=2.0)
    assert read("train_step_ms", run) == pytest.approx(500.0)
