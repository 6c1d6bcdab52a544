"""The traced run's device trace: torch.profiler over a bounded slice of the
window, reduced to what the per-layer metrics read.

The benchmark marks its own spans (`record_function("bench:<layer>")`
around each call into a layer); the profiler covers the few operations of
the slice, and its Chrome trace is read once the window has closed, then
deleted.  Device activity is every kernel, memcpy and memset event; the
slice's span runs from the first benchmark span's start to the last one's
end, on the trace's common clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench:"


def span(name: str):
    """A benchmark span around one call into a layer."""
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Summary:
    """What the per-layer metrics read from one slice's trace (times in
    seconds)."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(SPAN_PREFIX)]
        self.spans = [(e["name"][len(SPAN_PREFIX):], e["ts"] * 1e-6,
                       (e["ts"] + e["dur"]) * 1e-6) for e in spans]
        if self.spans:
            self.t0 = min(s[1] for s in self.spans)
            self.t1 = max(s[2] for s in self.spans)
        else:
            self.t0 = self.t1 = 0.0
        dev = [(e["cat"], e["name"], e["ts"] * 1e-6,
                (e["ts"] + e["dur"]) * 1e-6) for e in events
               if e.get("cat") in DEVICE_CATS
               and self.t0 <= e["ts"] * 1e-6 <= self.t1]
        self.device = [(n, a, b) for _, n, a, b in dev]
        self.kernels = [(n, a, b) for c, n, a, b in dev if c == "kernel"]
        tids = {e.get("tid") for e in spans}
        self.host = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                     for e in events
                     if e.get("cat") in ("cpu_op", "user_annotation")
                     and e.get("tid") in tids]
        self.busy = union([(max(a, self.t0), min(b, self.t1))
                           for _, a, b in self.device])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def kernel_s(self, needle: str) -> float:
        return sum(b - a for name, a, b in self.kernels if needle in name)

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def _host_at(self, t: float) -> str:
        """The benchmark span and the innermost host operation the host
        thread was in at time t."""
        span_name = next((n for n, a, b in self.spans if a <= t <= b), "-")
        inner: Optional[Tuple[str, float]] = None
        for name, a, b in self.host:
            if a <= t <= b and not name.startswith(SPAN_PREFIX):
                if inner is None or b - a < inner[1]:
                    inner = (name, b - a)
        return span_name + (" > " + inner[0] if inner else "")

    def top_gaps(self, k: int = 10) -> List[list]:
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(0.5 * (a + b)), b - a] for a, b in gaps[:k]]


class Slice:
    """torch.profiler over part of the window, CPU and CUDA activities."""

    def __init__(self):
        self.prof = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self):
        """Start and stop the profiler once, so that its own start-up is
        set-up and not window."""
        import torch
        with self._profile():
            with span("warm"):
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self):
        self.prof = self._profile()
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def read(self, tmpdir: Optional[str] = None) -> Summary:
        """The slice's Summary; the Chrome trace is written under tmpdir
        (TMPDIR by default) and deleted."""
        fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        self.prof = None
        return Summary(events)
