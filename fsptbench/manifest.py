"""BENCHMARK.json and the files it names, found by name.

A cell of `workloads` names a configuration (`fsptbench/configs/<config>.json`,
through `configs[].file`) and a traffic mix (`fsptbench/traffic/<mix>.json`);
each metric is read by `fsptbench/metrics/<name>.py` (a `read(run)` that
returns a number, or None where it finds nothing to read); a cell's
correctness limits are `fsptbench/checks/<cell>.json`; an asset kind that
scenegen.py does not build in is made by `fsptbench/generators/<kind>.py`
(a `make(params)` that returns OBJ text or an RGBA uint8 image).  Adding a
configuration, a generator, a mix of one of drive.KINDS (progressive,
drag, train), a metric, a cell or its checks is adding files and entries:
no file here changes.  A new traffic kind (an entry of drive.KINDS) or a
scene feature that the plain reference does not state yet
(reference/scene.py lists what it states) needs an edit.

A cell kept out of BENCHMARK.json waits in `fsptbench/parked/<cell>.json`
(its `workloads` entry and the metric entries only it reports);
`Manifest(parked=True)` merges those in, so that it still runs and is
tested.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _json(path):
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json"),
                 bench_dir: str = BENCH, parked: bool = False):
        self.data = _json(path)
        self.root = os.path.dirname(os.path.abspath(path))
        self.bench = bench_dir
        if parked:
            where = os.path.join(bench_dir, "parked")
            for name in sorted(os.listdir(where)):
                extra = _json(os.path.join(where, name))
                for group in ("workloads", "end_to_end", "per_layer"):
                    self.data[group] = self.data[group] + extra[group]

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, mix: str) -> dict:
        return _json(os.path.join(self.bench, "traffic", f"{mix}.json"))

    def limits(self, cell: str) -> dict:
        return _json(os.path.join(self.bench, "checks", f"{cell}.json"))

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of `cell` reports: the end-to-end ones
        untraced, the per-layer ones traced."""
        if not trace:
            return [m for m in self.data["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        e2e = {m["name"] for m in self.data["end_to_end"]
               if cell in m.get("workloads", [cell])}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]

    def reader(self, metric: str):
        """The `read(run)` of fsptbench/metrics/<metric>.py."""
        path = os.path.join(self.bench, "metrics", f"{metric}.py")
        return load_module(path, "fsptbench.metrics."
                           + metric.replace(".", "_")).read


def load_module(path: str, name: str):
    """The module of the Python file at `path`, run afresh."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
