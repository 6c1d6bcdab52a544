"""The port's per-phase replay (fspt_tpu_torch/scripts/perf_phase.py) on the
CPU, with the traversal kernels' plain versions: its capture of
`trace_paths`' loop reproduces `trace_paths` bit for bit, its compaction
groups are the JAX package's (`_compact_groups`, pure Python), the check
refuses a replay that drifts, kernel events go to the span that launched
them, and `main` runs end to end (no device number is measured on the
CPU).
"""

import dataclasses
import json

import pytest
import torch

from fspt_tpu_torch import bench
from fspt_tpu_torch.core import integrator, rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.runtime.renderer import Renderer
from fspt_tpu_torch.scripts import perf_phase
from fspt_tpu_torch.testing import make_bunny_standin_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return make_bunny_standin_scene(subdivisions=2)


def _configs():
    walk = perf_phase.default_config()
    return {
        # the bench configuration at one sample ("split", sort_state)
        "split32": dataclasses.replace(bench.bench_config(32, 1), bounces=4),
        # the JAX script's own ("walk", no state sort)
        "walk32": dataclasses.replace(walk, width=32, height=32, bounces=4),
        # 64x64 under a schedule tighter than the hits: two compactions,
        # Russian roulette at bounce 0 (2,048 lanes for more live ones)
        "split64": dataclasses.replace(bench.bench_config(64, 1), bounces=3,
                                       compact_schedule=(2, 4)),
    }


def _sample(scene, cfg):
    r = Renderer(scene, cfg, device="cpu")
    n = cfg.width * cfg.height
    key = rng.fold_in(rng.sample_key(r.base_key, 0), 0)
    cam = r.camera
    o, d = generate_rays(cam.position, cam.direction, cam.fov_scale,
                         cam.focal_depth, cam.aperture, r.resolution,
                         rng.stream_uniforms(key, 0, (4, n)),
                         pixel_idx=r.pixel_idx)
    return r.arrays, o, d, key


@pytest.mark.parametrize("case", ["split32", "walk32", "split64"])
def test_capture_reproduces_trace_paths(scene, case):
    from fspt_tpu.config import RenderConfig as JCfg
    from fspt_tpu.core.integrator import _compact_groups as jgroups
    cfg = _configs()[case]
    arrays, o, d, key = _sample(scene, cfg)
    n = cfg.width * cfg.height
    with torch.no_grad():
        rec = perf_phase.capture(arrays, cfg, scene.meta, o, d, key)
        radiance, stats = integrator.trace_paths(arrays, cfg, scene.meta, o,
                                                 d, key, return_stats=True)
    perf_phase.check_replay(rec, radiance, stats)
    for a, b in zip(rec["radiance"], radiance):
        assert torch.equal(a, b)
    assert rec["groups"] == jgroups(JCfg(**dataclasses.asdict(cfg)), n)
    assert rec["kernel_calls"] == integrator.traversal_launches(cfg, n, 1)
    assert len(rec["iters"]) == cfg.max_iters
    assert all(len(r["calls"]) == len(r["launches"]) == 1
               for r in rec["iters"])
    if case == "split64":
        assert [w for _, _, w in rec["compacts"]] == [2048, 1024]
        assert float(rec["rr_lanes"]) > 0        # RR fired, and still equal
    # the replayed hits answer a shading re-run as the launch did
    it0 = rec["iters"][0]
    s, _ = perf_phase._shade_and_scatter(
        arrays, cfg, scene.meta, it0["state"], it0["u"],
        (scene.meta.env_h, scene.meta.env_w), rec["attr"], rec["tex"],
        trace_fn=perf_phase._replayed_hits(it0["launches"]))
    s2, _ = perf_phase._shade_and_scatter(
        arrays, cfg, scene.meta, it0["state"], it0["u"],
        (scene.meta.env_h, scene.meta.env_w), rec["attr"], rec["tex"])
    for f in s._fields:
        assert torch.equal(torch.as_tensor(getattr(s, f)[0]),
                           torch.as_tensor(getattr(s2, f)[0]))


def test_check_replay_refuses_a_drift(scene):
    cfg = _configs()["split32"]
    arrays, o, d, key = _sample(scene, cfg)
    with torch.no_grad():
        rec = perf_phase.capture(arrays, cfg, scene.meta, o, d, key)
    radiance, stats = rec["radiance"], rec["stats"]
    bent = V3(radiance.x.clone(), radiance.y, radiance.z)
    bent.x[5] += 1e-3
    with pytest.raises(RuntimeError, match="radiance"):
        perf_phase.check_replay(rec, bent, stats)
    with pytest.raises(RuntimeError, match="rr_lanes"):
        perf_phase.check_replay(rec, radiance,
                                stats._replace(rr_lanes=stats.rr_lanes + 1))
    with pytest.raises(ValueError, match="replays trace_paths"):
        perf_phase.capture(arrays, dataclasses.replace(cfg, compact=False),
                           scene.meta, o, d, key)


def test_kernels_by_span():
    span = lambda i, ts, dur: {"cat": "user_annotation",
                               "name": f"{perf_phase.SPAN}{i}", "ts": ts,
                               "dur": dur}
    launch = lambda c, ts: {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "ts": ts, "dur": 1, "args": {"correlation": c}}
    kernel = lambda c, ts, dur: {"cat": "kernel", "name": "k", "ts": ts,
                                 "dur": dur, "args": {"correlation": c}}
    events = [span(0, 100, 50), span(1, 200, 50),
              {"cat": "user_annotation", "name": "other", "ts": 0,
               "dur": 1000},
              launch(1, 110), kernel(1, 260, 4.0),     # ran late: span 0
              launch(2, 120), kernel(2, 130, 2.0),
              launch(3, 210), kernel(3, 215, 8.0),
              kernel(4, 220, 1.0),                     # no launch event
              kernel(5, 500, 16.0)]                    # in no span
    out = perf_phase.kernels_by_span(events)
    assert out[f"{perf_phase.SPAN}0"] == [2, pytest.approx(0.006)]
    assert out[f"{perf_phase.SPAN}1"] == [2, pytest.approx(0.009)]
    assert out[""] == [1, pytest.approx(0.016)]


def test_main_cpu(scene, monkeypatch, capsys):
    monkeypatch.setattr(perf_phase, "REPS", 1)
    cfg = dataclasses.replace(bench.bench_config(32, 1), bounces=2)
    res = perf_phase.main(cfg, device="cpu", scene=scene)
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["config"] == "split+sort_state" and line["device"] == "cpu"
    phases = line["phases"]
    for p in ("raygen", "setup", "primary", "sort", "uniforms", "body",
              "shade", "si", "trav", "deposit", "tail", "trace_paths",
              "sum_of_phases"):
        assert phases[p]["wall_ms"] > 0, p
        assert phases[p]["device_ms"] is None and phases[p]["kernels"] is None
    assert any(x.startswith("[phase_cfg] config=split+sort_state") and
               "replay=bit-equal" in x for x in out)
    assert sum(x.startswith("[phase] config=split+sort_state it=") for x in
               out) >= cfg.max_iters
    assert res["launches"] == 0                  # the CPU launches nothing
    assert len(res["calls"]) == 1 + cfg.max_iters
    assert [b["it"] for b in res["table"]] == [None, 0, 1]
    assert all(b["bound"]["bound_ms"] > 0 and b["counts"]["node"] > 0
               for b in res["table"])
    # without the plain versions' runs: no bound, the same table otherwise
    res2 = perf_phase.main(cfg, device="cpu", scene=scene, plain=False)
    assert [(b["it"], b["lanes"], b["visits"]) for b in res2["table"]] == \
        [(b["it"], b["lanes"], b["visits"]) for b in res["table"]]
    assert all(b["bound"] is None and b["counts"] is None
               for b in res2["table"])
    assert "bound_by=not_measured" in capsys.readouterr().out
