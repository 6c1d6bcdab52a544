"""step_ms_p50: the median of the window's Renderer.step wall times (the
statistic of fspt_tpu_torch/bench.py, kept for continuity; the steps of
the profiled slice included)."""

from fsptbench.yardstick import median


def read(run):
    steps = [r["t1"] - r["t0"] for r in run.records]
    return median(steps) * 1e3 if steps else None
