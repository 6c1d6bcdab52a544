"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries only: the harness runs the cell and reports the
metric with no edit to a file it had.  An asset kind that scenegen.py does
not build in is found by name in the bench's generators/."""

import json
import os

import numpy as np
import pytest

from conftest import make_small
from fsptbench.manifest import Manifest
from fsptbench.reference.render import config
from fsptbench.run import run_cell
from fsptbench.scenegen import Assets


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


def test_asset_generators_found_by_name(tmp_path):
    gen = tmp_path / "generators"
    gen.mkdir()
    (gen / "stripes.py").write_text(
        "import numpy as np\n\n\ndef make(p):\n"
        "    img = np.zeros((p['res'], p['res'], 4), np.uint8)\n"
        "    img[::2] = 255\n    return img\n")
    (gen / "wrong.py").write_text(
        "import numpy as np\n\n\ndef make(p):\n"
        "    return np.zeros((4, 4, 3), np.float32)\n")
    a = Assets({"s.png": {"kind": "stripes", "res": 8},
                "q.obj": {"kind": "quad"}}, str(tmp_path))
    assert a.image("s.png").shape == (8, 8, 4)
    assert a.image("s.png")[0, 0, 0] == 255 and a.image("s.png")[1, 0, 0] == 0
    assert a.text("q.obj").startswith("v ")
    with pytest.raises(KeyError, match=str(gen / "absent.py")):
        Assets({"x.obj": {"kind": "absent"}}, str(tmp_path))
    with pytest.raises(TypeError, match="RGBA uint8"):
        Assets({"w.png": {"kind": "wrong"}}, str(tmp_path))
    assert np.array_equal(
        Assets({"c": {"kind": "checker", "res": 4, "squares": 2}}).items["c"],
        Assets({"c": {"kind": "checker", "res": 4, "squares": 2}},
               str(tmp_path)).items["c"])


def test_reference_states_the_render_mode_only():
    render = Manifest().config("bunny8_main")["render"]
    assert config(dict(render, use_light_nee=True), 1)["use_light_nee"]
    with pytest.raises(NotImplementedError):
        config(dict(render, mode="bvh_heatmap"), 1)
