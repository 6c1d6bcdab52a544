"""The port's bench entry point (fspt_tpu_torch/bench.py) on the CPU: its
result line, its per-bounce metrics against the JAX package's, its bound of
one sample, and its refusal to run without a card.

The metrics comparison runs intersector="brute" on both sides (no Pallas
call) at 32x32 under the default compaction schedule: at 1,024 lanes no
compaction shrinks the state, so Russian roulette cannot fire and both
integrators trace the same lanes; the counts must then be equal, not
close.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from fspt_tpu_torch import bench
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator
from fspt_tpu_torch.ops.traverse import ROW, SLAB_OPS
from fspt_tpu_torch.ops.traverse4 import packet_traverse4

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _count_wrapper_calls(monkeypatch):
    """On the CPU the wrapper runs the plain version and launches nothing;
    count its calls on its launch counter, as a card's launches count."""
    real = integrator.packet_traverse4

    def counted(*args, **kw):
        packet_traverse4.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(integrator, "packet_traverse4", counted)


def test_main_cpu_result_line(monkeypatch, capsys):
    for name, value in (("SUBDIV", 2), ("SIZE", 32), ("WARMUP", 1),
                        ("ITERS", 5), ("SPP", 2)):
        monkeypatch.setenv(f"FSPT_BENCH_{name}", str(value))
    _count_wrapper_calls(monkeypatch)
    returned = bench.main(device="cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(returned))
    for key in ("metric", "value", "unit", "ms_per_sample_median",
                "ms_per_sample_min", "ms_per_sample_max",
                "honest_rays_per_step", "traverse4_launches_per_step",
                "device"):
        assert key in line, key
    assert "vs_baseline" not in line
    assert line["unit"] == "rays/s" and line["value"] > 0
    assert "2 spp a step" in line["metric"] and "32x32" in line["metric"]
    assert (line["ms_per_sample_min"] <= line["ms_per_sample_median"]
            <= line["ms_per_sample_max"])
    assert line["steps"] == 5
    cfg = bench.bench_config(32, 2)
    assert line["traverse4_launches_per_step"] == \
        integrator.traversal_launches(cfg, 32 * 32, 2) * 1
    assert line["device"] == "cpu"
    assert "finite=True" in err
    assert "per-bounce scatter occupancy" in err and "rr_lanes=" in err
    assert "bound of one sample" in err


def test_summarize_refuses_a_wrong_launch_count():
    cfg = bench.bench_config(32, 2)

    class R:
        pass

    r = R()
    r.cfg = cfg
    want = integrator.traversal_launches(cfg, 32 * 32, 2)
    step = {"samples": 2, "seconds": 0.5, "rays": 1000.0}
    steps = [dict(step, launches=want), dict(step, launches=want - 1)]
    with pytest.raises(RuntimeError, match="traverse4 launched"):
        bench.summarize(r, steps, "cpu")
    line = bench.summarize(r, [dict(step, launches=want)] * 3, "cpu")
    assert line["ms_per_sample_median"] == 250.0
    assert line["value"] == 2000.0
    assert line["honest_rays_per_step"] == 1000.0


def test_step_metrics_match_jax():
    from fspt_tpu.config import RenderConfig as JCfg
    from fspt_tpu.runtime.renderer import Renderer as JRenderer
    from fspt_tpu.testing import make_bunny_standin_scene as jscene
    from fspt_tpu_torch.runtime.renderer import Renderer
    from fspt_tpu_torch.testing import make_bunny_standin_scene

    kw = dataclasses.asdict(bench.bench_config(32, 1))
    kw.update(intersector="brute",
              compact_schedule=RenderConfig().compact_schedule)
    cfg = RenderConfig(**kw)
    assert integrator._compact_groups(cfg, 32 * 32) == [[1024, 8]]
    ours = Renderer(make_bunny_standin_scene(subdivisions=2), cfg,
                    device="cpu").step_metrics()
    ref = JRenderer(jscene(subdivisions=2), JCfg(**kw)).step_metrics()
    for key in ("rays", "scatter_occupancy", "shadow_occupancy",
                "rr_lanes"):
        assert ours[key] == ref[key], (key, ours[key], ref[key])
    assert ours["rr_lanes"] == 0.0
    assert ours["visits_per_lane"] == ref["visits_per_lane"] == [0.0] * 8


def test_sample_bound_hand_count():
    metrics = {"visits_per_lane": [3.0, 0.5], "scatter_occupancy":
               [0.5, 0.25], "shadow_occupancy": [0.5, 0.25]}
    n, rows = 4096, 1000
    b = bench.sample_bound(n, [4096, 1024], metrics, rows)
    # primary: 4,096 rays, at least one visit each, the whole table (1,000
    # rows) read once; bounce 0: 8,192 lanes, 12,288 visits, the table;
    # bounce 1: 2,048 lanes, 2,048 visits > 1,000 rows, the table
    planes = (4096 + 8192 + 2048) * 12 * 4
    table = 3 * rows * ROW * 4
    shade = (2048 + 1024) * 107 * 4
    assert b["bytes"] == planes + table + shade
    assert b["flops"] == (4096 + 12288 + 2048) * SLAB_OPS
    assert b["bytes_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    assert b["flops_ms"] == pytest.approx(b["flops"] / 67e12 * 1e3)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]
    # few visits: a launch reads no more rows than it visits
    small = bench.sample_bound(64, [1024], {"visits_per_lane": [0.5],
                                            "scatter_occupancy": [0.5]}, rows)
    assert small["bytes"] == ((64 + 2048) * 48 + (64 + 32) * ROW * 4
                              + 32 * 107 * 4)


def test_cli_without_a_card_raises():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", FSPT_BENCH_SUBDIV="2",
               FSPT_BENCH_SIZE="32", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "fspt_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout.strip() == ""
