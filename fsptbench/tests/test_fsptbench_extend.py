"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries only: the harness runs the cell and reports the
metric with no edit to a file it had."""

import json
import os

from conftest import make_small
from fsptbench.manifest import Manifest
from fsptbench.run import run_cell


def test_throwaway_entries_are_found_by_name(tmp_path):
    root = str(tmp_path)
    bench = make_small(root).bench
    with open(os.path.join(bench, "configs", "bunny4_cli.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "throwaway"
    cfg["render"]["bounces"] = 2
    with open(os.path.join(bench, "configs", "throwaway.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "progressive.json")) as f:
        mix = json.load(f)
    mix["warmup_steps"] = 1
    with open(os.path.join(bench, "traffic", "quick.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "steps_done.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.records))\n")
    with open(os.path.join(bench, "checks", "throwaway.quick.json"),
              "w") as f:
        json.dump({"numbers": {"mismatch_share": {"limit": 0.05}}}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "throwaway", "source": "test",
                         "file": "fsptbench/configs/throwaway.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "throwaway.quick", "config": "throwaway",
                           "traffic": "quick", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "steps_done", "unit": "steps",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["throwaway.quick"]})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(b, f)
    m = Manifest(path, bench)
    r = run_cell("throwaway.quick", 7, 0.5, False, "cpu", m)
    assert r["correct"], r["checks"]
    assert r["metrics"]["steps_done"]["value"] == r["attempted"] >= 1
    assert set(r["metrics"]) == {"steps_done", "setup_s"}
