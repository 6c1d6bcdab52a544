"""Per-phase replay of one sample on the card (the counterpart of
scripts/perf_phase.py): where a sample's time and kernels go.

Run on the card, from the root of a checkout:

    python -m fspt_tpu_torch.scripts.perf_phase            # "walk"
    python -m fspt_tpu_torch.scripts.perf_phase --bench    # "split"

`main(cfg=None, device="cuda")`.  `cfg=None` is scripts/perf_phase.py's
own configuration (its lines 66-68 on top of RenderConfig's defaults:
"walk", csrc/walk.cu, compaction under (1.3, 8, 32, 64)) on the bench
scene at 512x512, 8 bounces; `--bench` (and chip_smoke.py) pass the bench
configuration at one sample a step (`bench.bench_config(512, 1)`: "split"
with the state sort, csrc/traverse4.cu).  The replay is of ONE unbatched sample, the one
`Renderer.step_metrics` traces, as the JAX script's is: `trace_paths`, not
the cross-sample `trace_paths_batched` of the bench's 8-sample step.

1. Capture (`capture`): the loop of core/integrator.py `trace_paths`, run
   phase by phase in its order — the set-up (lane ids, the packed texture
   and attribute tables), `_primary_state` (the primary launch),
   `_compact` for each group of `_compact_groups` whose width shrinks, and
   per bounce iteration `_bounce` in its parts: `_sort_state` (with
   cfg.sort_state), `stream_uniforms` and `_shade_and_scatter` — keeping
   each phase's inputs: the states, the iteration's uniforms as a tensor
   (so that a re-run of shading does not time the keys' set-up), every
   launch that shading makes through its `trace_fn` (both of an iteration
   with split_shadow) with its hits, and the kernel wrapper's own
   arguments of each launch.
2. Check: the capture's deposit, clipped as `trace_paths` clips it, and its
   TraceStats must equal `trace_paths` of the same rays and key bit for
   bit, or it raises (a replay that drifts would time phases that are not
   the real ones); then the traversal error flag is read (overflow,
   backstop), as `Renderer._sync` does.
3. Tally: each captured launch through the kernel's plain version, whose
   hits must equal the kernel's bit for bit and which counts the visits
   and the valid children and real triangles they tested: the launch's
   bound (ops/traverse.py `traversal_bound`).
4. Time each phase alone on its captured inputs: wall ms, the median of
   REPS synchronised runs after a warm-up; then one torch.profiler run of
   all phases (CUDA activity; each phase a `record_function` span that
   ends in a synchronise), whose kernel events go to the span whose host
   call launched them: a phase's kernel count and device ms.  On the CPU
   the profiler is not run: no device number is measured there.

Per iteration (the JAX script's columns): body (`_shade_and_scatter`),
trav (the kernel wrapper on its captured arguments), sort (`_sort_state`
with cfg.sort_state, else `sorted_intersect` - trav), uniforms, shade
(`_shade_and_scatter` with the traversal answered by the captured hits),
other (body - shade - `sorted_intersect`), the launch's lane-summed visits,
its bound and the bound's share of trav's device ms.  Then raygen
(outside `trace_paths`), set-up, primary, the compactions, the deposit,
the tail (the radiance clamp and the per-iteration stats) and their sum
against the whole `trace_paths`, kernels included, and last one JSON line
of the per-phase totals.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import statistics
import tempfile
import time

import torch

from fspt_tpu_torch.bench import bench_config, card_name
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import integrator, rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import (TraceStats, _attr_table, _clip,
                                            _compact, _compact_groups,
                                            _deposit, _packed_tables,
                                            _primary_state,
                                            _shade_and_scatter, _sort_state,
                                            sorted_intersect, trace_paths,
                                            trace_stats)
from fspt_tpu_torch.core.rng import stream_uniforms
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops import traverse, traverse3, traverse4
from fspt_tpu_torch.runtime.renderer import Renderer, _device
from fspt_tpu_torch.testing import make_bunny_standin_scene

REPS = 5                   # synchronised runs a phase's median is taken of
SPAN = "perf_phase/"       # the profiler spans' name prefix
# intersector -> (the integrator's kernel wrapper, its plain version, rays
# that share one row fetch)
KERNELS = {
    "split": ("packet_traverse4", traverse4.packet_traverse4_reference, 1),
    "walk": ("packet_traverse3", traverse3.packet_traverse3_reference,
             traverse3.GROUP),
}


def default_config() -> RenderConfig:
    """scripts/perf_phase.py's configuration on top of RenderConfig's
    defaults."""
    return RenderConfig(width=512, height=512, bounces=8,
                        extra_refraction_iters=0, batch_spp=1, compact=True,
                        compact_schedule=(1.3, 8, 32, 64))


@contextlib.contextmanager
def _spy(name):
    """Record (args, kwargs, hit) of every call of integrator.<name>, which
    still runs."""
    real, calls = getattr(integrator, name), []

    def spy(*args, **kw):
        hit = real(*args, **kw)
        calls.append((args, kw, hit))
        return hit

    setattr(integrator, name, spy)
    try:
        yield calls
    finally:
        setattr(integrator, name, real)


def _kernel(cfg: RenderConfig) -> str:
    """The name of the integrator's kernel wrapper that `cfg` launches;
    raises for a configuration the replay does not cover."""
    if cfg.intersector not in KERNELS or not cfg.compact \
            or cfg.mode != "render":
        raise ValueError("perf_phase replays trace_paths under compaction "
                         "with a traversal kernel (\"split\" or \"walk\"); "
                         f"got intersector={cfg.intersector!r}, "
                         f"compact={cfg.compact}, mode={cfg.mode!r}")
    return KERNELS[cfg.intersector][0]


def _tail(cfg, acc, per_it, n, rr_lanes):
    """The end of `trace_paths` after the deposit: the radiance clamp and
    the per-iteration stats."""
    radiance = V3(*(_clip(acc[:, i], 0.0, cfg.radiance_clamp)
                    for i in range(3)))
    return radiance, trace_stats(n, per_it, rr_lanes)


def capture(scene, cfg: RenderConfig, meta, origin: V3, direction: V3,
            key) -> dict:
    """Run `trace_paths`' loop (its `cfg.compact` branch) phase by phase and
    keep every phase's inputs (see the module docstring).  Returns a dict:
    groups, tex, attr, primary (the primary launch's kernel call), compacts
    [(state, it, width)], iters [{"it", "pre" (the state before the sort),
    "state", "u", "launches" [(o, d, active, tmax, any_hit, hit)],
    "calls" [(args, kwargs, hit)] (the kernel wrapper's)}], drops, final
    (the last state), per_it, rr_lanes, acc (the deposit), radiance,
    stats."""
    name = _kernel(cfg)
    integrator._check_streams(cfg)
    n = origin.x.shape[0]
    dev = origin.x.device
    env_hw = (meta.env_h, meta.env_w)
    rec = {"groups": _compact_groups(cfg, n), "compacts": [], "iters": [],
           "drops": [], "per_it": []}
    with _spy(name) as calls:
        # as trace_paths computes them at lane_offset 0
        gid0 = 0 + torch.arange(n, dtype=torch.int32, device=dev)
        tex = _packed_tables(scene, cfg, meta)
        attr = _attr_table(scene)
        lanes = torch.arange(n, dtype=torch.int32, device=dev)
        state = _primary_state(scene, cfg, meta, tex, origin, direction,
                               lanes, gid0)
        rec.update(origin=origin, direction=direction, lanes=lanes,
                   gid0=gid0, tex=tex, attr=attr, primary=calls[0])
        rr_lanes = torch.zeros((), dtype=torch.float32, device=dev)
        it0 = 0
        for w, count in rec["groups"]:
            if w < state.lidx.shape[0]:
                rec["compacts"].append((state, it0, w))
                state, drop, dropped = _compact(state, key, it0, w)
                rec["drops"].append(drop)
                rr_lanes = rr_lanes + dropped
            for it in range(it0, it0 + count):
                pre = state
                if cfg.sort_state:
                    state = _sort_state(scene, state)
                u = stream_uniforms(key, 1 + it, (11, state.lidx.shape[0]),
                                    lane_offset=state.gid)
                launches, k0 = [], len(calls)

                def trace_fn(o, d, a, tmax, any_hit=False):
                    hit = sorted_intersect(scene, cfg, meta, o, d, a, tmax,
                                           any_hit=any_hit)
                    launches.append((o, d, a, tmax, any_hit, hit))
                    return hit

                rec["iters"].append({"it": it, "pre": pre, "state": state,
                                     "u": u, "launches": launches})
                state, p = _shade_and_scatter(scene, cfg, meta, state, u,
                                              env_hw, attr, tex,
                                              trace_fn=trace_fn)
                rec["iters"][-1]["calls"] = calls[k0:]
                rec["per_it"].append(p)
            it0 += count
    acc = _deposit(rec["drops"], state, n)
    radiance, stats = _tail(cfg, acc, rec["per_it"], n, rr_lanes)
    rec.update(final=state, rr_lanes=rr_lanes, acc=acc, radiance=radiance,
               stats=stats, kernel_calls=len(calls))
    return rec


def check_replay(rec: dict, radiance: V3, stats: TraceStats):
    """Raise unless the capture's radiance and stats equal `trace_paths`'
    bit for bit."""
    for c, a, b in zip("xyz", rec["radiance"], radiance):
        if not torch.equal(a, b):
            raise RuntimeError(
                f"perf_phase: the replay's radiance ({c}) differs from "
                f"trace_paths' on {int((a != b).sum())} of {a.numel()} "
                "lanes; it would time other phases than the real ones")
    for f in TraceStats._fields:
        a, b = (getattr(s, f) for s in (rec["stats"], stats))
        if a is None and b is None:
            continue
        a, b = (torch.as_tensor(x) for x in (a, b))
        if not torch.equal(a, b):
            raise RuntimeError(f"perf_phase: the replay's TraceStats.{f} "
                               f"differs from trace_paths': {a} != {b}")


def kernels_by_span(events, prefix: str = SPAN) -> dict:
    """Chrome-trace `events` of a torch.profiler run -> {span name:
    [kernels, device ms]} over the `record_function` spans named
    prefix...: a kernel goes to the span in which its host launch call (the
    runtime event of its correlation id) lies, or where none is in the
    trace, its own start.  Kernels in no span go to "" (none where every
    span ends in a synchronise)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix))
    starts = [s[0] for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {s[2]: [0, 0.0] for s in spans}
    out[""] = [0, 0.0]
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        i = bisect.bisect_right(starts, t) - 1
        name = spans[i][2] if i >= 0 and t <= spans[i][1] else ""
        out[name][0] += 1
        out[name][1] += e["dur"] / 1e3
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, dev, reps: int = REPS) -> float:
    """Median wall ms of fn() over `reps` runs, each ended by a synchronise,
    after one warm-up run."""
    fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_phases(entries, dev) -> dict:
    """One torch.profiler run (CPU and CUDA activity) of every (key, fn) of
    `entries`, each in a span of its own that ends in a synchronise ->
    {key: (kernels, device ms)}, and the kernels in no span under None."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, (_, fn) in enumerate(entries):
            with record_function(f"{SPAN}{i}"):
                fn()
                _sync(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = kernels_by_span(events)
    out = {key: tuple(spans.get(f"{SPAN}{i}", (0, 0.0)))
           for i, (key, _) in enumerate(entries)}
    out[None] = tuple(spans[""])
    return out


def _replayed_hits(launches):
    """A trace_fn that answers a shading re-run with the captured hits, in
    the order the launches were made."""
    hits = iter(launch[5] for launch in launches)
    return lambda o, d, a, tmax, any_hit=False: next(hits)


def phase_entries(scene, cfg, meta, rec, raygen, key, run_kernel) -> list:
    """(key, fn) of every phase to time: key is (it or None, phase)."""
    env_hw = (meta.env_h, meta.env_w)
    tex, attr = rec["tex"], rec["attr"]
    n = rec["acc"].shape[0]
    dev = rec["acc"].device
    trav = lambda calls: lambda: [run_kernel(*a, **kw) for a, kw, _ in calls]

    def setup():
        0 + torch.arange(n, dtype=torch.int32, device=dev)
        torch.arange(n, dtype=torch.int32, device=dev)
        _packed_tables(scene, cfg, meta)
        _attr_table(scene)
        torch.zeros((), dtype=torch.float32, device=dev)      # rr_lanes

    def compact(state, it, w):
        _, _, dropped = _compact(state, key, it, w)
        return rec["rr_lanes"] + dropped

    o, d = rec["origin"], rec["direction"]
    entries = [((None, "raygen"), raygen), ((None, "setup"), setup),
               ((None, "primary"), lambda: _primary_state(
                   scene, cfg, meta, tex, o, d, rec["lanes"], rec["gid0"])),
               ((None, "primary_trav"), trav([rec["primary"]]))]
    for state, it, w in rec["compacts"]:
        entries.append(((it, "compact"),
                        lambda s=state, i=it, w=w: compact(s, i, w)))
    for r in rec["iters"]:
        it, s, u, launches = r["it"], r["state"], r["u"], r["launches"]
        if cfg.sort_state:
            entries.append(((it, "sort"),
                            lambda p=r["pre"]: _sort_state(scene, p)))
        entries += [
            ((it, "uniforms"), lambda it=it, s=s: stream_uniforms(
                key, 1 + it, (11, s.lidx.shape[0]), lane_offset=s.gid)),
            ((it, "body"), lambda s=s, u=u: _shade_and_scatter(
                scene, cfg, meta, s, u, env_hw, attr, tex)),
            ((it, "shade"), lambda s=s, u=u, ls=launches: _shade_and_scatter(
                scene, cfg, meta, s, u, env_hw, attr, tex,
                trace_fn=_replayed_hits(ls))),
            ((it, "si"), lambda ls=launches: [
                sorted_intersect(scene, cfg, meta, lo, ld, la, tm, any_hit=ah)
                for lo, ld, la, tm, ah, _ in ls]),
            ((it, "trav"), trav(r["calls"]))]
    entries += [
        ((None, "deposit"), lambda: _deposit(rec["drops"], rec["final"], n)),
        ((None, "tail"), lambda: _tail(cfg, rec["acc"], rec["per_it"], n,
                                       rec["rr_lanes"])),
        ((None, "trace_paths"), lambda: trace_paths(
            scene, cfg, meta, o, d, key, return_stats=True))]
    return entries


def launch_table(rec: dict, cfg: RenderConfig, table_rows: int,
                 plain: bool = True) -> list:
    """Each captured kernel call (the primary launch first, then each
    iteration's in order) -> [{"it" (None for the primary), "lanes",
    "visits" (lane-summed, the kernel's), "counts", "bound"}].  With
    `plain`, the call runs again through the kernel's plain version, which
    must find the kernel's hits bit for bit and counts the visits and the
    valid children and real triangles they tested: "bound" is the launch's
    `traversal_bound`.  Without it, "counts" and "bound" are None."""
    _, ref_fn, group = KERNELS[cfg.intersector]
    out = []
    calls = [(None, rec["primary"])] + [(r["it"], c) for r in rec["iters"]
                                        for c in r["calls"]]
    for it, (args, kw, hit) in calls:
        row = {"it": it, "lanes": hit.t.numel(),
               "visits": int(hit.visits.sum()), "counts": None,
               "bound": None}
        if plain:
            counts = {}
            ref = ref_fn(*args, **kw, counts=counts)
            for f in hit._fields:
                if not torch.equal(getattr(hit, f), getattr(ref, f)):
                    raise RuntimeError(
                        f"perf_phase: the kernel and its plain version "
                        f"differ in {f} on the launch of iteration {it}")
            row["counts"] = counts
            row["bound"] = traverse.traversal_bound(
                row["lanes"], kw.get("tree_width", 8), kw["leaf_size"],
                table_rows, counts.get("node", 0), counts.get("leaf", 0),
                child_tests=counts.get("children", 0),
                tri_tests=counts.get("triangles", 0), group=group)
        out.append(row)
    return out


def _fmt(x, spec=".3f"):
    return "not_measured" if x is None else format(x, spec)


def main(cfg: RenderConfig | None = None, device="cuda", scene=None,
         plain: bool = True) -> dict:
    """Replay, check, tally and time one sample of `cfg` (default:
    `default_config()`) on `scene` (default: the bench scene,
    `make_bunny_standin_scene(6)`) and print the tables (see the module
    docstring).  `plain=False` leaves out the plain versions' runs of the
    launches (their bounds then read not_measured): under "walk" they take
    most of a call on the card (~3-6 s a launch).  Returns {"totals":
    {phase: {"wall_ms", "device_ms", "kernels"}}, "calls": [(args,
    kwargs)] of every captured kernel call, primary first, "launches": the
    kernel's launches in the capture, "table": `launch_table`'s list}."""
    dev = _device(device)
    cfg = cfg or default_config()
    counter = getattr(integrator, _kernel(cfg))
    card = card_name(dev)
    if scene is None:
        scene = make_bunny_standin_scene(subdivisions=6)
    r = Renderer(scene, cfg, device=dev)
    arrays, meta = r.arrays, scene.meta
    n = cfg.width * cfg.height
    key = rng.fold_in(rng.sample_key(r.base_key, 0), 0)
    cam = r.camera

    def raygen():
        cam_u = rng.stream_uniforms(key, 0, (4, n), device=dev)
        return generate_rays(cam.position, cam.direction, cam.fov_scale,
                             cam.focal_depth, cam.aperture, r.resolution,
                             cam_u, pixel_idx=r.pixel_idx)

    cuda = dev.type == "cuda"
    with torch.no_grad():
        origin, direction = raygen()
        counter.launches = 0
        rec = capture(arrays, cfg, meta, origin, direction, key)
        _sync(dev)
        launches = counter.launches
        radiance, stats = trace_paths(arrays, cfg, meta, origin, direction,
                                      key, return_stats=True)
        _sync(dev)
        check_replay(rec, radiance, stats)
        traverse.check_stack_overflow(dev)
        expected = integrator.traversal_launches(cfg, n, 1)
        if rec["kernel_calls"] != expected or (cuda and launches != expected):
            raise RuntimeError(
                f"perf_phase: the capture made {rec['kernel_calls']} kernel "
                f"calls ({launches} launches on the card), expected "
                f"{expected}")
        table_rows = arrays.pk_nodes.shape[0] + arrays.pk_leaves.shape[0]
        table = launch_table(rec, cfg, table_rows, plain)
        entries = phase_entries(arrays, cfg, meta, rec, raygen, key, counter)
        wall = {k: wall_ms(fn, dev) for k, fn in entries}
        prof = profile_phases(entries, dev) if cuda else {}
        traverse.check_stack_overflow(dev)
    return report(cfg, rec, wall, prof, table, card, launches)


def report(cfg, rec, wall, prof, table, card, launches) -> dict:
    """Print the replay's tables (see the module docstring) and return
    main's result."""
    label = cfg.intersector + ("+sort_state" if cfg.sort_state else "")
    dev_ms = lambda k: prof[k][1] if k in prof else None
    kernels = lambda k: prof[k][0] if k in prof else None

    def minus(a, *b):
        return None if a is None or None in b else a - sum(b)

    totals = {}

    def add(phase, w, d, k):
        t = totals.setdefault(phase, {"wall_ms": 0.0, "device_ms": 0.0,
                                      "kernels": 0})
        t["wall_ms"] += w
        for f, x in (("device_ms", d), ("kernels", k)):
            t[f] = None if x is None or t[f] is None else t[f] + x

    def bound_of(rows, dev):
        """(bound ms, bound_by, % of the device ms) of launch rows."""
        if any(b["bound"] is None for b in rows):
            return None, "not_measured", None
        ms = sum(b["bound"]["bound_ms"] for b in rows)
        by = "+".join(b["bound"]["bound_by"] for b in rows)
        return ms, by, (ms / dev * 100 if dev else None)

    for key in wall:
        add(key[1], wall[key], dev_ms(key), kernels(key))
    print(f"[phase_cfg] config={label} size={cfg.width}x{cfg.height} "
          f"bounces={cfg.bounces} schedule={cfg.compact_schedule} "
          f"groups={rec['groups']} kernel_launches={launches} "
          f"replay=bit-equal device={card!r}", flush=True)
    print(f"{'it':>3} {'width':>7} {'launch':>7} {'body':>8} {'trav':>8} "
          f"{'sort':>8} {'unif':>8} {'shade':>8} {'other':>8} "
          f"{'visits':>9} {'bound_ms':>9} {'%bound':>7}   (wall ms)",
          flush=True)
    for r in rec["iters"]:
        it = r["it"]
        k = lambda p: (it, p)
        rows = [b for b in table if b["it"] == it]
        bound_ms, bound_by, pct = bound_of(rows, dev_ms(k("trav")))
        cells = {p: (wall[k(p)], dev_ms(k(p)), kernels(k(p)))
                 for p in ("sort", "uniforms", "body", "shade", "si", "trav")
                 if k(p) in wall}
        if not cfg.sort_state:
            # the launch's own sort runs inside sorted_intersect
            cells["sort"] = tuple(minus(cells["si"][i], cells["trav"][i])
                                  for i in range(3))
            add("sort", *cells["sort"])
        cells["other"] = tuple(minus(cells["body"][i], cells["shade"][i],
                                     cells["si"][i]) for i in range(3))
        add("other", *cells["other"])
        visits = sum(b["visits"] for b in rows)
        print(f"{it:3d} {r['state'].lidx.shape[0]:7d} "
              f"{sum(b['lanes'] for b in rows):7d} "
              + " ".join(f"{cells[p][0]:8.3f}" for p in
                         ("body", "trav", "sort", "uniforms", "shade",
                          "other"))
              + f" {visits:9d} {_fmt(bound_ms, '9.5f')} "
              f"{_fmt(pct, '7.2f')}", flush=True)
        print(f"[phase] config={label} it={it} "
              f"width={r['state'].lidx.shape[0]} "
              + " ".join(f"{p}={w:.3f}/{_fmt(d)}/{_fmt(c, 'd')}"
                         for p, (w, d, c) in cells.items())
              + f" visits={visits} bound_ms={_fmt(bound_ms, '.5f')} "
              f"bound_by={bound_by} pct_of_bound={_fmt(pct, '.2f')} "
              "(wall_ms/device_ms/kernels)", flush=True)
    for key in wall:
        if key[0] is not None and key[1] != "compact":
            continue
        extra = ""
        if key[1] == "primary_trav":
            b = table[0]
            bound_ms, bound_by, pct = bound_of([b], dev_ms(key))
            extra = (f" lanes={b['lanes']} visits={b['visits']} "
                     f"bound_ms={_fmt(bound_ms, '.5f')} bound_by={bound_by} "
                     f"pct_of_bound={_fmt(pct, '.2f')}")
        print(f"[phase] config={label} it={'-' if key[0] is None else key[0]}"
              f" phase={key[1]} wall_ms={wall[key]:.3f} "
              f"device_ms={_fmt(dev_ms(key))} "
              f"kernels={_fmt(kernels(key), 'd')}{extra}", flush=True)
    # what trace_paths runs: its set-up, the primary state, the
    # compactions, each iteration's sort (with sort_state; without it the
    # sort runs inside the body's sorted_intersect), uniforms and body, the
    # deposit and the tail
    parts = [p for p in ("setup", "primary", "compact", "uniforms", "body",
                         "deposit", "tail") if p in totals]
    if cfg.sort_state:
        parts.append("sort")
    s = {"wall_ms": sum(totals[p]["wall_ms"] for p in parts)}
    for f in ("device_ms", "kernels"):
        vals = [totals[p][f] for p in parts]
        s[f] = None if None in vals else sum(vals)
    totals["sum_of_phases"] = s
    for phase, t in totals.items():
        print(f"[phase_total] config={label} phase={phase} "
              f"wall_ms={t['wall_ms']:.3f} device_ms={_fmt(t['device_ms'])} "
              f"kernels={_fmt(t['kernels'], 'd')}", flush=True)
    full = totals["trace_paths"]
    print(f"[phase_total] config={label} phase=reconcile "
          f"trace_paths_kernels={_fmt(full['kernels'], 'd')} "
          f"sum_of_phases_kernels={_fmt(s['kernels'], 'd')} "
          f"gap={_fmt(minus(full['kernels'], s['kernels']), 'd')} "
          f"outside_spans={_fmt(kernels(None), 'd')} "
          f"trace_paths_wall_ms={full['wall_ms']:.3f} "
          f"sum_of_phases_wall_ms={s['wall_ms']:.3f}", flush=True)
    print(json.dumps({"config": label, "size": cfg.width, "device": card,
                      "phases": totals}), flush=True)
    calls = [rec["primary"][:2]] + [c[:2] for r in rec["iters"]
                                    for c in r["calls"]]
    return {"totals": totals, "calls": calls, "launches": launches,
            "table": table}


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description="Per-phase replay of one 512x512 sample on the card.")
    ap.add_argument("--bench", action="store_true",
                    help="the bench configuration at 1 spp (\"split\", the "
                         "state sort: csrc/traverse4.cu) in place of the "
                         "script's own (\"walk\": csrc/walk.cu)")
    main(bench_config(512, 1) if ap.parse_args().bench else None)
