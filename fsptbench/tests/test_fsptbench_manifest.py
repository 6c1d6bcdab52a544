"""BENCHMARK.json against the benchmark contract's shape, and every file
it names found by name."""

import json
import os
import re

import pytest

from fsptbench.manifest import BENCH, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["fsptbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])


def test_names_and_units(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_the_contract_asks(bench):
    m = Manifest()
    for cell in bench["workloads"]:
        assert cell["chips"] == 1
        e2e = [x["name"] for x in m.metrics(cell["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics(cell["name"], True)
        for x in m.metrics(cell["name"], True):
            assert x["moves"] in e2e


def test_files_found_by_name(bench):
    m = Manifest()
    for c in bench["configs"]:
        cfg = m.config(c["name"])
        assert c["file"].startswith("fsptbench/configs/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for cell in bench["workloads"]:
        assert m.traffic(cell["traffic"])["kind"]
        assert m.limits(cell["name"])["numbers"]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(m.reader(metric["name"]))


def test_config_holds_every_render_field():
    import dataclasses
    from fspt_tpu_torch.config import RenderConfig
    fields = {f.name for f in dataclasses.fields(RenderConfig)} - {"seed"}
    for name in ("bunny8_main", "bunny4_cli"):
        with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
            assert set(json.load(f)["render"]) == fields


def test_parked_cells_are_whole(bench):
    """A parked cell names no entry of BENCHMARK.json again, and once
    merged in it reports what a cell of BENCHMARK.json has to."""
    m = Manifest(parked=True)
    parked = [w for w in m.data["workloads"] if w not in bench["workloads"]]
    assert parked
    for group in ("workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m.data[group]]
        assert len(names) == len(set(names))
    for cell in parked:
        assert NAME.match(cell["name"]) and cell["chips"] == 1
        e2e = [x["name"] for x in m.metrics(cell["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        for x in m.metrics(cell["name"], True):
            assert x["moves"] in e2e and callable(m.reader(x["name"]))
        assert m.traffic(cell["traffic"])["kind"]
        assert m.limits(cell["name"])["numbers"]
