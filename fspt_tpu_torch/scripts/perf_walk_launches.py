"""Every traversal launch of one sample, first design against current kernel.

The two render paths launch their kernel many times a sample, and the
launches differ: the primary rays, the first bounce (the longest), and the
later bounces, where few lanes are alive and a launch lasts as long as its
longest walk.  This study captures the launches of one sample of the bench
configuration ("split": csrc/traverse4.cu) and of the default configuration
without compaction ("walk": csrc/walk.cu `fspt_walk3`) on the bench scene at
512x512, and times each with the first design of the kernel
(csrc/traverse4_v0.cu, csrc/walk_v0.cu) and with the current one (through
the launchers of ops/_versus.py), after checking that the two agree bit for
bit; and the launches of one "packet" sample with the packet walk as one
1,024-thread block (csrc/walk.cu `fspt_walk1_block`) and as a thread block
cluster (csrc/walk1.cu `fspt_walk1`).  For the group walk it also times
each launch with its groups handed out longest first (by the visit counts
the launch itself reports: what an order known in advance could gain), and
with csrc/walk_divide.cu, the current kernel built with the compiler's own
1.0f / x in the leaf tests (what the split reciprocal of walk.cu buys).

Run on the card:
    python -m fspt_tpu_torch.scripts.perf_walk_launches
    python -m fspt_tpu_torch.scripts.perf_walk_launches --row-fetch
    python -m fspt_tpu_torch.scripts.perf_walk_launches --cluster-barrier
The second form builds and runs row_fetch_bench.cu beside this file: the
cycles a lone warp takes to draw 1, 2, 4 and 9 table rows from L2 by plain
loads, asynchronous copies and bulk copies.  The third builds and runs
cluster_barrier_bench.cu: the cycles a packet's vote costs across a thread
block cluster of 2, 4 and 8 blocks against one 1,024-thread block.

All are measurement studies that no render path needs: they stay because
PERF.md and the headers of csrc/walk.cu and csrc/walk1.cu cite their
numbers (the per-launch times of a sample, the longest-first times, the
row-fetch and barrier cycles), and a cited number needs the script that
produced it.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from fspt_tpu_torch.ops import _build, traverse3
from fspt_tpu_torch.ops._versus import (TRAVERSE4_SOURCES, WALK1_DESIGNS,
                                        WALK_SOURCES, traverse4_launcher,
                                        walk_launcher)
from fspt_tpu_torch.ops.traverse import check_stack_overflow

BENCH_SCHEDULE = (1.5, 11, 48, 160, 640, 2048, 2048, 2048)
SIZE = 512
GROUP = traverse3.GROUP
WALK_DIVIDE = "walk_divide"     # csrc/walk.cu with plain reciprocals


def device_ms(fn, reps=20):
    """Mean device time of fn() over `reps` runs after one warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(module, name, run):
    """The (args, kwargs) of every call `run()` makes to module.<name>."""
    real, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, real)
    return calls


def longest_first(args, visits):
    """The launch with its groups reordered by falling visit count."""
    from fspt_tpu_torch.core.vec import V3
    nodes, leaves, ro, rd, tmax = args
    g = visits[::GROUP]
    order = torch.argsort(g, descending=True)
    idx = (order[:, None] * GROUP
           + torch.arange(GROUP, device=g.device)[None]).reshape(-1)
    pick = lambda v: V3(*(x[idx].contiguous() for x in v))
    return (nodes, leaves, pick(ro), pick(rd),
            None if tmax is None else tmax[idx].contiguous())


def compare(label, calls, launcher, old, new, reorder=False, variant=None):
    """Per launch: old ms, new ms (and new ms longest first, and the ms of
    `variant`, another build of the new source with the same results);
    returns the sums over the sample's launches."""
    total = {"old": 0.0, "new": 0.0, "variant": 0.0}
    for k, (args, kw) in enumerate(calls):
        n = args[2].x.shape[0]
        if n == 0:
            continue
        f_old, f_new = launcher(old, args, kw), launcher(new, args, kw)
        a, b = f_old(), f_new()
        for f in a._fields:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{label} launch {k}: the two designs "
                                     f"differ in {f}")
        t_old, t_new = device_ms(f_old), device_ms(f_new)
        total["old"] += t_old
        total["new"] += t_new
        line = (f"[{label}] launch={k} lanes={n} "
                f"any_hit={kw.get('any_hit', False)} "
                f"max_visits={int(b.visits.max())} old_ms={t_old:.4f} "
                f"new_ms={t_new:.4f} speedup={t_old / t_new:.2f}")
        if reorder and n % GROUP == 0:
            t_lf = device_ms(launcher(new, longest_first(args, b.visits), kw))
            line += f" new_ms_longest_first={t_lf:.4f}"
        if variant:
            # in turns with the new kernel: new, variant, variant, new
            f_var = launcher(variant, args, kw)
            c = f_var()
            for f in b._fields:
                if not torch.equal(getattr(b, f), getattr(c, f)):
                    raise AssertionError(f"{label} launch {k}: {variant} "
                                         f"differs in {f}")
            t = [device_ms(f) for f in (f_new, f_var, f_var, f_new)]
            total["variant"] += (t[1] + t[2]) / 2
            total["new_in_turns"] = (total.get("new_in_turns", 0.0)
                                     + (t[0] + t[3]) / 2)
            line += (f" {variant}_ms={(t[1] + t[2]) / 2:.4f} "
                     f"new_ms_in_turns={(t[0] + t[3]) / 2:.4f}")
        print(line, flush=True)
    print(f"[{label}] sample old_ms={total['old']:.4f} "
          f"new_ms={total['new']:.4f} "
          f"speedup={total['old'] / total['new']:.2f}"
          + (f" {variant}_ms={total['variant']:.4f} "
             f"new_ms_in_turns={total['new_in_turns']:.4f}"
             if variant else ""), flush=True)
    return total


def walk1_launcher(source, args, kw):
    """walk_launcher for the packet walk: each source's own entry point."""
    return walk_launcher(source, args, kw, dict(WALK1_DESIGNS)[source])


def run_bench(name):
    """Build <name>.cu beside this file with nvcc and run it; returns what
    it printed."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    exe = os.path.join(_build.BUILD_DIR, name)
    subprocess.run([_build._nvcc(), "-O3", "-arch=sm_90a", "-o", exe,
                    os.path.join(here, f"{name}.cu")], check=True)
    out = subprocess.run([exe], check=True, capture_output=True,
                         text=True).stdout
    print(out, end="", flush=True)
    return out


def main(scene=None):
    if not torch.cuda.is_available():
        raise SystemExit("perf_walk_launches: needs a CUDA device")
    from fspt_tpu_torch import RenderConfig, Renderer
    from fspt_tpu_torch.core import integrator, rng
    from fspt_tpu_torch.core.camera import generate_rays
    from fspt_tpu_torch.testing import make_bunny_standin_scene
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all(TRAVERSE4_SOURCES + WALK_SOURCES
                     + (WALK_DIVIDE, "walk1"))
    scene = scene or make_bunny_standin_scene(subdivisions=6)
    base = dict(width=SIZE, height=SIZE, bounces=8, extra_refraction_iters=0,
                batch_spp=8)
    split = RenderConfig(**base, compact=True, wavefront_batch=True,
                         sort_state=True, intersector="split",
                         nee_env_nearest=True, escape_env_nearest=True,
                         compact_schedule=BENCH_SCHEDULE)
    walk = RenderConfig(**base, intersector="walk")
    packet = RenderConfig(**base, intersector="packet")
    r = Renderer(scene, split, device="cuda")
    a, meta = r.arrays, scene.meta
    n = SIZE * SIZE
    k0 = rng.fold_in(rng.sample_key(r.base_key, 0), 0)
    cam = r.camera
    o, d = generate_rays(cam.position, cam.direction, cam.fov_scale,
                         cam.focal_depth, cam.aperture, r.resolution,
                         rng.stream_uniforms(k0, 0, (4, n), device=dev),
                         pixel_idx=r.pixel_idx)
    out = {}
    for label, cfg, name, launcher, (old, new) in (
            ("traverse4", split, "packet_traverse4", traverse4_launcher,
             TRAVERSE4_SOURCES),
            ("walk3", walk, "packet_traverse3", walk_launcher,
             WALK_SOURCES),
            ("walk1", packet, "packet_traverse", walk1_launcher,
             ("walk", "walk1"))):
        with torch.no_grad():
            calls = capture(integrator, name, lambda: integrator.trace_paths(
                a, cfg, meta, o, d, k0))
        torch.cuda.synchronize()
        out[label] = compare(label, calls, launcher, old, new,
                             reorder=label == "walk3",
                             variant=WALK_DIVIDE if label == "walk3" else None)
    torch.cuda.synchronize()
    check_stack_overflow(dev)
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["--row-fetch"]:
        run_bench("row_fetch_bench")
    elif sys.argv[1:] == ["--cluster-barrier"]:
        run_bench("cluster_barrier_bench")
    else:
        main()
