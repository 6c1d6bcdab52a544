"""One run of one cell of BENCHMARK.json: set up, measure for --seconds,
check what the window produced against the plain reference, print the
result as the last line of standard output.

    python3 -m fsptbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Untraced, the result's metrics are the cell's end-to-end metrics; traced
(--trace 1), a bounded slice of the window runs under torch.profiler and
the metrics are the cell's per-layer ones, with the device's busy and
window seconds and a breakdown of the slice.  The run needs an NVIDIA
card: without one, or with fewer than the cell asks for, it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from fsptbench import importcheck
from fsptbench.manifest import ROOT, Manifest


def _process_start() -> float:
    """The process's start on the perf_counter clock (Linux)."""
    with open("/proc/self/stat") as f:
        ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(age, 0.0)


T_START = _process_start()


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


class Run:
    """The state of one run, handed to the driver and the metric readers."""

    def __init__(self, manifest: Manifest, workload: str, seed: int,
                 seconds: float, device: str):
        self.manifest = manifest
        self.cell = manifest.cell(workload)
        self.config = manifest.config(self.cell["config"])
        self.mix = manifest.traffic(self.cell["traffic"])
        self.limits = manifest.limits(workload)
        self.seed, self.seconds = seed, seconds
        self.device = device
        self.records, self.facts, self.slice_work = [], {}, {}
        self.slice = None
        self.window_s = self.setup_s = 0.0
        self.attempted = self.failed = 0

    def build(self):
        from fspt_tpu_torch import RenderConfig, load_scene_dict
        from fsptbench.reference.render import config
        from fsptbench.scenegen import Assets
        c = self.config
        self.assets = Assets(c["assets"], self.manifest.bench)
        self.scene_dict = c["scene"]
        self.scene = load_scene_dict(self.scene_dict, self.assets,
                                     name=c["name"], **c["loader"])
        self.ref_cfg = config(c["render"], self.seed)
        render = dict(c["render"], seed=self.seed)
        render["compact_schedule"] = tuple(render["compact_schedule"])
        self.cfg = RenderConfig(**render)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", manifest: Manifest = None) -> dict:
    """One run; returns the result dict.  device="cpu" drives the same run
    with the program's plain kernels (the tests' rehearsal): it reports
    host times only, and no device number."""
    import torch
    from fsptbench.drive import KINDS
    from fsptbench.profiling import Slice

    run = Run(manifest or Manifest(), workload, seed, seconds, device)
    if device == "cuda":
        os.environ["FSPT_NATIVE_CACHE"] = os.path.join(
            ROOT, "fspt_tpu_torch", "_build")
    t = time.perf_counter()
    run.facts["import_s"] = t - T_START
    run.build()
    run.facts["scene_s"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = KINDS[run.mix["kind"]](run)
    driver.setup()
    run.facts["program_setup_s"] = time.perf_counter() - t
    if trace and device == "cuda":
        run.slice = Slice()
        run.slice.warm()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - T_START
    driver.window()
    mem = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    if run.slice is not None:
        run.slice = run.slice.read()
    metrics = {}
    for m in run.manifest.metrics(workload, trace):
        v = run.manifest.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t = time.perf_counter()
    numbers = driver.check()
    run.facts["check_s"] = time.perf_counter() - t
    from fsptbench.checks import judge
    verdict = judge(numbers, run.limits)
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else device),
                   "count": 1, "memory_peak_bytes": mem}
    result = {"correct": all(v["ok"] for v in verdict.values())
              and run.failed == 0,
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if run.slice is not None:
        device_info["busy_s"] = run.slice.busy_s
        device_info["window_s"] = run.slice.window_s
        result["breakdown"] = {"device_ops": run.slice.top_ops(),
                               "idle_gaps": run.slice.top_gaps()}
    result["facts"] = dict(run.facts, window_s=run.window_s,
                           slice_work=run.slice_work)
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in verdict.items()}
    return result


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m fsptbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--parked", action="store_true",
                   help="also find the cells of fsptbench/parked/")
    args = p.parse_args(argv)
    importcheck.check_sources()
    importcheck.check_process()
    manifest = Manifest(parked=args.parked)
    chips = manifest.cell(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _say(f"fsptbench: the cell needs {chips} CUDA device(s); "
             f"torch.cuda.is_available()={torch.cuda.is_available()}, "
             f"device_count={torch.cuda.device_count()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", manifest)
    bad = importcheck.loaded()
    if bad:
        _say("fsptbench: loaded in this process: " + ", ".join(bad))
        return 3
    card = _power_limit()
    result["device"]["power_limit"] = card
    _say(f"# {args.workload} seed={args.seed} card={card} "
         f"facts={json.dumps(result['facts'])}")
    for name, c in result["checks"].items():
        _say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
