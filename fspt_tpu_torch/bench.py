"""Throughput benchmark of the port on one NVIDIA GPU (the counterpart of the
repository's bench.py).

Run on the card, from the root of a checkout:

    python -m fspt_tpu_torch.bench

The workload is bench.py's: the ~82k-triangle bunny stand-in
(`testing.make_bunny_standin_scene`), 8 bounces, the main path's
configuration (`bench_config`: compaction under a tail-tightened schedule,
the cross-sample wavefront batch, the state sort, "split" traversal,
nearest-texel env lookups) at FSPT_BENCH_SPP samples a step.  The settings
come from the environment as bench.py reads them: FSPT_BENCH_SUBDIV (6),
FSPT_BENCH_SIZE (512), FSPT_BENCH_WARMUP (2), FSPT_BENCH_ITERS (8),
FSPT_BENCH_SPP (8).

After the warm-up, each of the ITERS steps is timed alone (`Renderer.step`
ends in a synchronise of the card), because the host's time swings from
step to step: the result is the median ms/sample with its min and max.
The last line of standard output is one JSON object: `metric`, `value`
(honest rays/s: active-lane rays traced over the wall seconds of all timed
steps, `TraceStats.rays`), `unit`, `ms_per_sample_median`/`_min`/`_max`,
`honest_rays_per_step`, `traverse4_launches_per_step` (read from
`packet_traverse4.launches` around each step, which must equal
`integrator.traversal_launches`) and `device` (the card's name and power
limit as `nvidia-smi` gives them, or "cpu").  Standard error carries the
scene's size, the build and first-step seconds, the per-bounce occupancy,
visits a lane and RR-dropped lanes of one unbatched sample
(`Renderer.step_metrics`), and the card's bound for one sample
(`sample_bound`) against the measured median.  The per-phase split of a
sample is `python -m fspt_tpu_torch.scripts.perf_phase`.

`main(device="cuda")` raises without a card (the Renderer's own check);
the tests call `main(device="cpu")`, where the plain PyTorch versions of
the kernels run and launch nothing, so the launch count reads 0 unless the
caller counts the wrapper's calls.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator
from fspt_tpu_torch.ops.traverse import (H100_BYTES_PER_S,
                                         H100_F32_OPS_PER_S, traversal_bound)
from fspt_tpu_torch.ops.traverse4 import packet_traverse4
from fspt_tpu_torch.runtime.renderer import Renderer, _device
from fspt_tpu_torch.testing import make_bunny_standin_scene

# bench.py's schedule (the round-5 re-tune for 8-sample batches)
SCHEDULE = (1.5, 11, 48, 160, 640, 2048, 2048, 2048)
# f32 columns a live lane's shading reads, as bench.py reckons them: the
# 43-column attribute row, two 24-column packed material rows, 4 env-bin
# columns, 6 for the NEE env texel and 6 for the escape env texel
SHADE_COLUMNS = 43 + 48 + 4 + 6 + 6


def settings() -> dict:
    """bench.py's settings, from the environment."""
    env = lambda name, default: int(os.environ.get(f"FSPT_BENCH_{name}",
                                                   default))
    return {"subdiv": env("SUBDIV", 6), "size": env("SIZE", 512),
            "warmup": env("WARMUP", 2), "iters": env("ITERS", 8),
            "spp": env("SPP", 8)}


def bench_config(size: int, spp: int) -> RenderConfig:
    """bench.py's RenderConfig (bench.py:57-63), field for field."""
    return RenderConfig(width=size, height=size, bounces=8,
                        extra_refraction_iters=0, batch_spp=spp,
                        compact=True, wavefront_batch=spp > 1,
                        sort_state=True, intersector="split",
                        nee_env_nearest=True, escape_env_nearest=True,
                        compact_schedule=SCHEDULE)


def card_name(device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them, or
    "cpu"."""
    if _device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_steps(r: Renderer, iters: int) -> list:
    """Run `iters` steps of `r`, each timed alone, with
    `packet_traverse4.launches` set to 0 before each and read after it.
    Returns one dict a step: samples, seconds (the step's wall time, from
    `Renderer.stats`), honest rays and traverse4 launches."""
    steps = []
    for _ in range(iters):
        s0 = r.stats
        packet_traverse4.launches = 0
        r.step()
        launches = packet_traverse4.launches
        s1 = r.stats
        steps.append({k: s1[k] - s0[k] for k in ("samples", "seconds",
                                                 "rays")})
        steps[-1]["launches"] = launches
    return steps


def summarize(r: Renderer, steps: list, device: str) -> dict:
    """The result line of `steps` (from `time_steps`) as a dict; raises
    unless every step launched traverse4 `integrator.traversal_launches`
    times."""
    cfg = r.cfg
    n = cfg.width * cfg.height
    expected = integrator.traversal_launches(cfg, n, cfg.batch_spp)
    launches = {s["launches"] for s in steps}
    if launches != {expected}:
        raise RuntimeError(f"bench: traverse4 launched {sorted(launches)} "
                           f"times a step, expected {expected}")
    ms = [s["seconds"] / s["samples"] * 1e3 for s in steps]
    seconds = sum(s["seconds"] for s in steps)
    rays = sum(s["rays"] for s in steps)
    return {
        "metric": f"rays/s/chip, active lanes (bunny-scale standin, "
                  f"{cfg.bounces} bounces, {cfg.batch_spp} spp a step, "
                  f"{cfg.width}x{cfg.height})",
        "value": rays / seconds,
        "unit": "rays/s",
        "ms_per_sample_median": statistics.median(ms),
        "ms_per_sample_min": min(ms),
        "ms_per_sample_max": max(ms),
        "steps": len(steps),
        "honest_rays_per_step": rays / len(steps),
        "traverse4_launches_per_step": expected,
        "device": device,
    }


def sample_bound(n: int, widths, metrics: dict, table_rows: int) -> dict:
    """The least time one H100 could take for one unbatched sample of the
    bench configuration, from `Renderer.step_metrics()`: the larger of its
    bytes over the card's memory rate and its operations over its float32
    rate (ops/traverse.py `traversal_bound`'s rates).

    n: the sample's rays; widths: the path state's lanes at each bounce
    iteration (`_compact_groups` run out), whose traversal launch takes the
    scatter and the env-shadow rays together (2 x width lanes).
    Bytes: the traversal launches as `traversal_bound` counts them (each ray
    plane read and each hit plane written once, and each table row its
    visits can have touched read once: one row a visit under "split", at
    most the whole table a launch), and each live lane's shading reads
    SHADE_COLUMNS f32 columns (`scatter_occupancy`).  The primary launch
    makes at least one visit a ray; a bounce launch's visits are
    `visits_per_lane` x n, which counts its scatter rays' visits only.
    Operations: one child test (SLAB_OPS) a visit, the least a visit does:
    step_metrics does not split visits into node and leaf visits or count
    what they tested (scripts/perf_phase.py gives each launch its exact
    bound).  Returns {"bytes", "flops", "bytes_ms", "flops_ms", "bound_ms",
    "bound_by"}."""
    launches = [(n, n)] + [(2 * w, round(v * n)) for w, v in
                           zip(widths, metrics["visits_per_lane"])]
    nbytes = flops = 0
    for lanes, visits in launches:
        # the tested children are given, so the tree's widths do not enter
        b = traversal_bound(lanes, 8, 8, table_rows, visits, 0,
                            child_tests=visits, tri_tests=0)
        nbytes += b["bytes"]
        flops += b["flops"]
    live = round(sum(metrics["scatter_occupancy"]) * n)
    nbytes += live * SHADE_COLUMNS * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def main(device="cuda"):
    dev = _device(device)       # raises here without a card, before the scene
    s = settings()
    card = card_name(dev)
    t0 = time.perf_counter()
    scene = make_bunny_standin_scene(subdivisions=s["subdiv"])
    build_s = time.perf_counter() - t0
    cfg = bench_config(s["size"], s["spp"])
    r = Renderer(scene, cfg, device=dev)
    t0 = time.perf_counter()
    r.step()                    # builds the kernels on first use + 1 batch
    first_s = time.perf_counter() - t0
    r.step(s["warmup"])
    steps = time_steps(r, s["iters"])
    line = summarize(r, steps, card)
    finite = bool(np.isfinite(r.hdr_image()).all())
    err = lambda *a: print(*a, file=sys.stderr, flush=True)
    per_step = ",".join(f"{x['seconds'] / x['samples'] * 1e3:.2f}"
                        for x in steps)
    err(f"# triangles={scene.num_triangles} bvh_depth={scene.bvh_depth} "
        f"scene_build={build_s:.1f}s first_step={first_s:.1f}s "
        f"ms_per_sample_by_step={per_step} finite={finite} device={card}")
    m = r.step_metrics()
    for label, key in (("scatter occupancy", "scatter_occupancy"),
                       ("shadow  occupancy", "shadow_occupancy"),
                       ("traverse4 visits/lane", "visits_per_lane")):
        err(f"# per-bounce {label}: "
            + " ".join(f"{x:.3f}" for x in m[key]))
    n = cfg.width * cfg.height
    widths = [w for w, count in integrator._compact_groups(cfg, n)
              for _ in range(count)]
    table_rows = r.arrays.pk_nodes.shape[0] + r.arrays.pk_leaves.shape[0]
    b = sample_bound(n, widths, m, table_rows)
    med = line["ms_per_sample_median"]
    err(f"# bound of one sample on one H100: {b['bytes'] / 1e6:.1f} MB, "
        f"{b['flops'] / 1e9:.3f} GFLOP => {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}); measured median {med:.2f} ms/sample "
        f"({b['bound_ms'] / med * 100:.2f}% of it)")
    err(f"# per-sample rr_lanes={m['rr_lanes']:.0f} (RR-dropped lanes; "
        f"unbiased reweighting); phase breakdown: "
        f"python -m fspt_tpu_torch.scripts.perf_phase")
    if not finite:
        raise RuntimeError("bench: the image is not finite")
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
