#!/usr/bin/env python3
"""Smoke test of the fspt_tpu_torch port on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. device: name, `nvidia-smi` name and power limit, torch/CUDA versions;
  2. build: nvcc builds the seven sources of csrc/ (traverse4, walk,
     walk1, walk5, dense_mt, micro, pcg4d) concurrently into
     fspt_tpu_torch/_build/; nvcc seconds and each kernel's registers and
     spills;
  3. scene: the bench scene (82k-triangle bunny stand-in) onto the card; how
     full its 8-wide nodes and 8-triangle leaves are;
  4. kernel vs plain, traverse4 ("split"): the CUDA kernel against its plain
     PyTorch version on one sample's 262,144 primary rays and on the port's
     own bounce-0 scatter+shadow launch — bit-equal slot/visits/t/u/v,
     any-hit flags and per-ray tmax clipping — plus 4,096 rays against
     brute-force Moller-Trumbore over every triangle; times of both; a
     [shape] line per launch (the per-ray visits' sum, mean, p50/p99/max,
     node/leaf split, the valid children and real triangles a visit tested,
     dead and root-only shares, the lockstep loss of 32
     and of 4 rays a warp, the launch's bound);
  5. width 16: the bench scene packed 16-wide; traverse4 and walk3 on the
     primary rays, each bit-equal to its plain version and finding the
     8-wide tables' slots;
  6. kernel vs plain, the group walks: walk3 ("walk") on the primary rays
     and on the port's own sorted bounce-0 launch of the CLI's --no-compact
     configuration (2 x 262,144 lanes), walk1 ("packet", csrc/walk1.cu: a
     packet a thread block cluster) on the primary rays and on the bounce-0
     launch of a "packet" step; nearest, any-hit and clipped runs
     bit-equal, lane counts
     bit-equal on the primary rays; times of both; for walk3 a [shape]
     line per launch (per-group visits with p50/p99/max, node/leaf split,
     the bound, where the launch order's last block ends in visits against
     an even share over 5 blocks an SM, and from the kernel's work tally
     the (ray, row) pairs its ray masks left to test, their share of the
     group visits' 128 lanes and the bound of their tests); then walk3 on
     the exact-replay cell's first sorted bounce launch (the dungeon of
     fsptbench/configs/dungeon8_exact.json at 512x512, 3 x 262,144 lanes,
     `dungeon_walk3`, ~1 minute with the scene): bit-equal as above, a
     [shape] line, its time against both bounds; for walk1 a [shape] line per
     launch (per-packet visits with p50/p99/max, where the launch order's
     last packet ends against an even share over one block an SM, the
     bound, and the cycles a visit of the longest packet);
 6b. pcg4d (`phase_pcg4d`): csrc/pcg4d.cu through core/rng.py
     `stream_uniforms` against its plain int64 chain
     (`stream_uniforms_reference`) at the main path's shapes, bunny8's first
     bounce (11 x 175,104, a device key row, the gid column of the state's
     row gather), the merged phase (11 x 191,488, key_rows) and raygen
     (4 x 262,144, a lane offset): bit-equal, one launch each; a [pcg4d]
     line each with the kernel's device time (queued), the chain's eagerly
     and as a CUDA graph replay (its device time, as a replayed sample step
     ran it), and the store bound (the uniforms and ids over 3.35 TB/s);
  7. golden: 32x32 renders on the card against tests/goldens/bunny_class.npy
     under "split" and under the default "walk", and heatmap.npy
     (tests/test_goldens.py's 5% bound);
  8. bench: the bench configuration ("split") at 512x512, 8 bounces, 8 spp
     per step, timed by fspt_tpu_torch/bench.py's own functions — one
     warm-up step, then BENCH_STEPS steps each timed alone with the
     kernel's launch count reset before and read after each (`time_steps`;
     `summarize` raises unless every step launched traverse4
     `traversal_launches` times); rays/s, the median, min and max
     ms/sample, and bench.py's JSON line under a [bench_json] tag; the
     per-bounce occupancy; the image must be finite and non-zero;
  9. walk bench: the CLI's --no-compact configuration ("walk", no
     compaction, per-launch sort) at 512x512, 8 bounces, 8 spp per step —
     one warm-up step, then 2 timed steps, walk3's launch count checked;
 10. packet: one 1-spp step of the same configuration under "packet",
     walk1's launch count checked;
 11. heatmap: mode="bvh_heatmap" at 512x512, 1 spp; mean lane count; PNG;
 12. CLI: `python -m fspt_tpu_torch render` of a tiny scene file with and
     without --no-compact in a subprocess; each must exit 0 and write a PNG;
 13. v5 (fspt_tpu_torch/scripts): the captured bounce-0 launch of the
     round-5 studies; packet_traverse5 (csrc/walk5.cu, a program a thread
     block cluster) at its defaults against its plain version — nearest,
     any-hit and clipped runs bit-equal, per-walk visits included — and its
     slots against traverse4's on the same launch (equal up to coplanar
     ties); a [shape] line (per-walk visits with p50/p99/max, node/leaf
     split, the longest walk of a program against its mean, the bound);
     then the v4/v5 sweep of perf_r5i.main(), walk5's launch count read
     around it;
 14. dense MT: csrc/dense_mt.cu against its plain version, bit-equal, on
     stand-in tiles and on 64 tiles of captured rays, T = 64 and 128; then
     the two-level study perf_r5_treelet.main(), its launch count read, and
     the kernel at stage E (T=64, the study's tile count) timed on the
     device alone (the launches wait behind a sleep kernel: one is shorter
     than its wrapper's host time, which `wrapper_ms` shows);
 15. micro: csrc/micro.cu against its plain version at k=64 for all eight
     variants, bit-equal, `leaf` and `leaf2` also at k=512, and `full` and
     `leaf4` at K=4096, the shape perf_r5d.main() launches, once each (the
     plain version at K=4096 costs ~45 s for `full` and ~120 s for `leaf4`,
     so the other variants do not take it); then perf_r5d.main() at K=4096
     (ns/substep),
     its launch count read (a count of calls: a call of the leaf family is
     three kernel launches);
 16. train: the differentiable path (parallel/dist.py make_train_step) on
     the bench scene at 512x512 under the bench configuration without the
     cross-sample batch ("split", 8 bounces, 1 spp a step).  The target is
     the step's own render at the scene's parameters; from env_rgb and emit
     scaled by 0.5, 3 plain gradient-descent steps on those two fields at
     TRAIN_LR, every step at the same key and step_idx=0, so the loss is a
     deterministic function of the parameters and must fall.  A [train]
     line a step (loss, ms, peak memory, traverse4's launches in the step
     against its calls and the expected count), the median ms, then the
     directional derivative of the loss along one seeded direction of the
     env texels against a central difference (h=5e-3, bound 2e-2 relative,
     as tests/test_grad_fd.py), and one step under the default
     configuration ("walk"), fspt_walk3's launches counted.
 17. refit and animate: the bench scene with the bunny an animated prop
     keyframed over frames 0-3 (`anim_scene_dict`: a translation, a
     rotation about y, a uniform scale).  Per frame: `refit_arrays` from the
     base frame's tables on the card (median of 3, synchronised around
     each) against the host rebuild (`load_scene_dict` + `to_torch`);
     traverse4 on the refit tables against its plain version on the
     frame's 262,144 primary rays and its bounce-0 launch, bit-equal; the
     same primary rays on the refit and the rebuilt tables, the original
     triangles (through each build's `slot_tri`) equal but for ties at
     equal t (1e-5 relative) and for leaks through an edge (at most 1e-4
     of the rays, each the refit tables' own nearest hit by brute force,
     the vertices of the two builds within 1e-5); walk3 (the --no-compact
     configuration's kernel) on the refit tables finding traverse4's slots
     up to ties at equal t; mean visits a ray on both; the stack and
     backstop flags read.  Then `render_animation` with refit=True and
     refit=False over frames 0-2 at 512x512, 8 bounces, the bench
     configuration, 8 spp a frame (one batch, a checkpoint after it):
     ms a frame, traverse4's launches a frame against
     `traversal_launches`, and each frame's PNGs within
     tests/test_refit.py's bounds (mean |diff| < 2/255, 99th percentile
     <= 4/255).  Then `python -m fspt_tpu_torch animate` of a tiny
     keyframed scene, --end 2, with and without --refit, in a subprocess;
 18. view: `InteractiveViewer` on the card over the bench scene under the
     bench configuration, headless: the first frame (`start` captures both
     renderers' CUDA graphs before it; one capture each, checked at the
     end); a drag (look events
     at 20 Hz from a thread) until previews arrive, with each event's
     time; `moveend` until a progressive frame; an envTheta restart; ms a
     preview and a full frame from the renderers' own step times;
     traverse4's launches over the phase; then `serve` on a free loopback
     port: GET / (the page), POST /input (204), GET /frame (a PNG with
     X-Meta).  Every wait has its own deadline (28 s in all);
 19. profile: `Renderer.profile_trace` of one bench step (8 spp) into
     OUT_DIR/profile, the step a replay of the CUDA graph captured before
     the profiler started: the trace's kernel events, traverse4's among
     them (one a launch its counter counts), one `fspt.replay` span and no
     `fspt.traverse` span (the phases run on the device alone), the
     kernels' summed device time against the step's wall time from its
     `fspt.step` span (the device's busy share), and the five kernels with
     the most device time; the trace is kept gzipped;
 20. dist (parallel/): the bench scene at 512x512 under the bench
     configuration without the cross-sample batch and with the default
     compaction schedule (`dist_cfg`: "split", 8 bounces, compact,
     sort_state, nearest env, 2 spp a step).  [dist_render]: an 8-shard
     mesh held by this process on the one card, 2 steps, each pixel
     against `Renderer.step` of the same configuration (rtol 1e-5, atol
     1e-6; the bit-equal share and the largest difference printed), the
     sum of the shards' rays against the renderer's honest rays, the
     balance efficiency at 8, traverse4's launches a step against 8 x
     `traversal_launches` of a shard, ms a step; [dist_walk]: one 8-shard
     step under "walk", each pixel against `Renderer.step` under "walk"
     with the same bounds, fspt_walk3's launches counted; then shard 0's
     primary launch of each (traverse4 and walk3 at the shard's 32,768
     rays) held bit for bit to its plain version; [dist_scaling]:
     `measure_scaling` at 1, 2, 4, 8 shards, 1 step each, and its table
     (the shards of one process run one after another on one card, so its
     wall-clock is informational); then jobs of subprocess ranks through
     `multihost.initialize` on free loopback ports, all at once, each rank
     `python3 chip_smoke.py --dist-worker ...` (torch and fspt_tpu_torch
     only): [dist_group] two ranks on the one card over gloo (NCCL refuses
     two ranks on one card), [dist_nccl] one NCCL rank, and where the
     machine has two cards or more, two NCCL ranks, one a card.  Each rank
     renders the sharded 512² step (1 spp) over the global mesh and takes
     one train step there; its gathered image must equal the one-process
     mesh of the same size bit for bit, its loss and gradients within rtol
     1e-5 of it (the backward's scatter-adds are not ordered on the card).
     A job that fails or passes its deadline (150 s) fails the run.  With
     one card it prints {"cards": 1, "cross_card": "not run"}.
 21. perf_phase (fspt_tpu_torch/scripts/perf_phase.py): the per-phase
     replay of one unbatched 512x512 sample, under the bench configuration
     at 1 spp ("split", the state sort: traverse4) and under the script's
     own configuration ("walk": walk3), each through `perf_phase.main`
     with the kernel's launch count reset before and read after: the
     replay is held bit for bit to `trace_paths`, under "split" every
     captured launch to its plain version (under "walk" those runs take
     ~40 s and are left to the standalone script: `plain=False`), and the
     [phase] rows and [phase_total] lines
     give each phase's wall ms, device ms and kernels; then the captured
     bounce-0 launch of each through `check_launch` (nearest, any-hit,
     clipped, bit-equal), its tally equal to the replay's, and a
     [phase_summary] line each.
 22. graph: `Renderer.step` replaying its CUDA graph (runtime/renderer.py
     StepGraph) at the bench's settings (bunny8: 8 spp, the wavefront
     batch) and the CLI's (bunny4: 4 spp, 4 bounces, a sample at a time)
     at 512x512 on the bench scene, against eager `sample_step` calls on a
     second renderer: accum, count and rays bit-equal after the capture
     and after GRAPH_STEPS steps of each kind timed in turns; traverse4's
     launches a replayed step equal to `traversal_launches`; one capture;
     a [graph] line each with the capture's host time (the capture pass
     and the graph's instantiation), the eager first step, the step that
     captured, and the median ms/sample eager and replayed; pcg4d's launches
     a replayed step equal to an eager step's.
Then one JSON line with the kernels' numbers (each row with its bound from
ops/traverse.py `traversal_bound`, computed from this run's visit counts and
the valid children and real triangles those visits tested, and its launches
per step; traverse4's row also its launches a refit animation frame of phase
17 and over phase 18's viewer, traverse4's and walk3's rows their launches a
sharded step of phase 20 and over phase 21), the card's name and power
limit, and last the result line.  Images go to OUT_DIR (below).

    python3 chip_smoke.py --kernels-only

stops after phase 6b (build, kernel checks, [shape] and [pcg4d] lines) and
prints no result line: a short call after a kernel edit.

It imports nothing of JAX or of the JAX package.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
BENCH_STEPS = 8          # phase 8's timed steps (fspt_tpu_torch/bench.py's)


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps, warmup=True, queued=False):
    """Mean device time of fn() over `reps` runs, after one warm-up run
    unless told otherwise.  With `queued` the runs wait in the stream behind
    a ~25 ms sleep kernel, so that a launch shorter than the host's time to
    issue it through its wrapper is timed on the device alone."""
    import torch
    if warmup:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def brute_force(a, o, d, tmax, chunk=4096):
    """Nearest hit of rays (o, d: (M, 3)) over every triangle slot by the
    kernel's Moller-Trumbore test; ties keep the lowest slot."""
    import torch
    v0, e1, e2 = a.tri_v0, a.tri_e1, a.tri_e2
    best_t = tmax.clone()
    best_s = torch.full_like(tmax, -1, dtype=torch.int64)
    for s0 in range(0, v0.shape[0], chunk):
        c0, c1, c2 = (x[s0:s0 + chunk][None] for x in (v0, e1, e2))
        dd = d[:, None, :]
        p = torch.cross(dd.expand(-1, c2.shape[1], -1),
                        c2.expand(d.shape[0], -1, -1), dim=-1)
        det = (c1 * p).sum(-1)
        inv = 1.0 / torch.where(det.abs() < 1e-6, torch.ones_like(det), det)
        tv = o[:, None, :] - c0
        u = (tv * p).sum(-1) * inv
        q = torch.cross(tv, c1.expand(d.shape[0], -1, -1), dim=-1)
        w = (dd * q).sum(-1) * inv
        t = (c2 * q).sum(-1) * inv
        ok = ((det.abs() >= 1e-6) & (u >= 0) & (u <= 1) & (w >= 0)
              & (u + w <= 1) & (t > 1e-6) & (t < best_t[:, None]))
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        tm, im = t.min(dim=1)
        better = tm < best_t
        best_t = torch.where(better, tm, best_t)
        best_s = torch.where(better, im + s0, best_s)
    return best_t, best_s


def compare(name, hit, ref, fields=("t", "slot", "u", "v", "visits")):
    import torch
    for f in fields:
        a, b = getattr(hit, f), getattr(ref, f)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"in {f} on {bad} of {a.numel()} rays")
    return max(float((getattr(hit, f) - getattr(ref, f)).abs().max())
               for f in ("t", "u", "v"))


def lockstep_loss(visits, width):
    """Sum over consecutive `width`-ray sets of width x the set's longest
    walk, over the sum of all walks: the factor by which lanes that wait
    for their set's longest ray inflate the work."""
    import torch
    pad = (-visits.numel()) % width
    v = torch.cat([visits, visits.new_zeros(pad)]).reshape(-1, width)
    return float(v.max(1).values.sum() * width) / float(visits.sum())


def launch_bound(counts, lanes, tree_width, leaf_size, table_rows, group=1):
    """ops/traverse.py `traversal_bound` of a launch from the tally its plain
    version made: visits, and the valid children and real triangles those
    visits tested."""
    from fspt_tpu_torch.ops.traverse import traversal_bound
    return traversal_bound(lanes, tree_width, leaf_size, table_rows,
                           counts["node"], counts["leaf"],
                           child_tests=counts["children"],
                           tri_tests=counts["triangles"], group=group)


def tested(counts):
    """The mean valid children a node visit and real triangles a leaf visit
    of a tally."""
    per = lambda part, whole: f"{counts[part] / max(counts[whole], 1):.2f}"
    return dict(children_per_node_visit=per("children", "node"),
                triangles_per_leaf_visit=per("triangles", "leaf"))


def bound_fields(b):
    return dict(bound_ms=f"{b['bound_ms']:.5f}", bound_by=b["bound_by"],
                mbytes=f"{b['bytes'] / 1e6:.2f}",
                gflop=f"{b['flops'] / 1e9:.4f}")


def shape_traverse4(label, hit, tmax, counts, bound, ms):
    """The per-ray visits of a traverse4 launch, and its bound."""
    import torch
    v = hit.visits
    q = torch.quantile(v.float(), torch.tensor([0.5, 0.99], device=v.device))
    dead = (float((tmax <= 0).float().mean()) if tmax is not None else 0.0)
    if counts["node"] + counts["leaf"] != int(v.sum()):
        raise AssertionError(f"{label}: node + leaf visits differ from "
                             "the kernel's visits")
    say("shape", launch=label, lanes=v.numel(), visits=int(v.sum()),
        node_visits=counts["node"], leaf_visits=counts["leaf"],
        **tested(counts), mean=f"{v.float().mean().item():.3f}",
        p50=f"{q[0].item():.0f}",
        p99=f"{q[1].item():.0f}", max=int(v.max()),
        dead_share=f"{dead:.4f}",
        root_only_share=f"{float((v == 1).float().mean()):.4f}",
        lockstep_loss_32=f"{lockstep_loss(v, 32):.3f}",
        lockstep_loss_4=f"{lockstep_loss(v, 4):.3f}",
        **bound_fields(bound), share_of_bound=f"{bound['bound_ms'] / ms:.4f}")


def inorder_makespan(visits, slots):
    """Groups handed out in launch order to `slots` resident blocks, each
    taking its visit count: (the last block's end, the sum over slots)."""
    import heapq
    v = visits.tolist()
    ends = [0] * min(slots, len(v))
    for x in v:
        heapq.heappush(ends, heapq.heappop(ends) + x)
    return max(ends), sum(v) / slots


def walk3_bounds(hit, counts, tally, kw, table_rows, group=128):
    """A walk3 launch's bound from its work tally: the child and triangle
    tests of the (ray, row) pairs its ray masks left, and a row fetch a
    group visit; and beside it the union's bound, every lane of a group
    tested at every row its group visits (the plain version's tally, the
    work of the first design).  Returns (bound, union)."""
    from fspt_tpu_torch.ops.traverse import traversal_bound
    n, tw, ls = hit.t.numel(), kw.get("tree_width", 8), kw["leaf_size"]
    bound = traversal_bound(n, tw, ls, table_rows, tally["visits"] * group,
                            0, child_tests=tally["children"],
                            tri_tests=tally["triangles"], group=group)
    return bound, launch_bound(counts, n, tw, ls, table_rows, group=group)


def shape_walk3(label, hit, counts, tally, bound, union, ms, group=128):
    """The per-group visits of a walk3 launch and how far the launch
    order's longest groups stretch it (a launch ends when its last group
    does); the (ray, row) pairs its ray masks left to test, as a share of
    its group visits' 128 lanes; its bound (`walk3_bounds`) and the
    union's."""
    import torch
    g = hit.visits[::group]
    if counts["node"] + counts["leaf"] != int(g.sum()) * group:
        raise AssertionError(f"{label}: node + leaf visits differ from "
                             "the kernel's visits")
    if tally["visits"] != int(g.sum()):
        raise AssertionError(f"{label}: the work tally counts "
                             f"{tally['visits']} group visits, the kernel's "
                             f"visits {int(g.sum())}")
    q = torch.quantile(g.float(), torch.tensor([0.5, 0.99], device=g.device))
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    last, even = inorder_makespan(g.cpu(), sms * 5)
    say("shape", launch=label, lanes=hit.visits.numel(), groups=g.numel(),
        group_visits=int(g.sum()), mean=f"{g.float().mean().item():.2f}",
        p50=f"{q[0].item():.0f}", p99=f"{q[1].item():.0f}", max=int(g.max()),
        last_block_ends_at_visits=last, even_share_visits=f"{even:.0f}",
        node_group_visits=counts["node"] // group,
        leaf_group_visits=counts["leaf"] // group, **tested(counts),
        tested_pairs=tally["pairs"],
        pair_share=f"{tally['pairs'] / (int(g.sum()) * group):.4f}",
        rays_per_visit=f"{tally['pairs'] / int(g.sum()):.2f}",
        **bound_fields(bound),
        share_of_bound=f"{bound['bound_ms'] / ms:.4f}",
        union_bound_ms=f"{union['bound_ms']:.5f}",
        union_bound_by=union["bound_by"],
        share_of_union_bound=f"{union['bound_ms'] / ms:.4f}")


def dungeon_walk3():
    """walk3 on the exact-replay cell's first sorted bounce launch
    (fsptbench/configs/dungeon8_exact.json at 512x512: 3 x 262,144 lanes
    over ~400,000 triangles), the cell's own launch: the kernel against
    its plain version (`check_launch`), its [shape] line with the work
    tally, and its time against its bound and the union's (`walk3_bounds`).
    Returns (ms, plain ms, max |diff|, bound, union)."""
    from fsptbench.manifest import Manifest
    from fsptbench.run import Run
    from fspt_tpu_torch.ops.traverse import capture_launches
    from fspt_tpu_torch.core import integrator
    from fspt_tpu_torch.ops.traverse3 import (packet_traverse3,
                                              packet_traverse3_reference,
                                              tally_growth)
    from fspt_tpu_torch.runtime.renderer import Renderer
    t0 = time.perf_counter()
    run = Run(Manifest(), "dungeon8_exact.progressive", 2_300_000_001, 1.0,
              "cuda")
    run.build()
    r = Renderer(run.scene, run.cfg, device="cuda")
    a = r.arrays
    table_rows = a.pk_nodes.shape[0] + a.pk_leaves.shape[0]
    args, kw = capture_launches(integrator, "packet_traverse3", r.step)[1]
    say("dungeon", cell="dungeon8_exact.progressive",
        triangles=run.scene.num_triangles, node_rows=a.pk_nodes.shape[0],
        leaf_rows=a.pk_leaves.shape[0], lanes=args[2].x.shape[0],
        stack_depth=kw["stack_depth"],
        seconds=f"{time.perf_counter() - t0:.2f}")
    counts = {}
    label = "walk3 dungeon bounce0"
    ms, plain_ms, err, hit = check_launch(
        label, packet_traverse3, packet_traverse3_reference, args, kw,
        counts=counts)
    tally = tally_growth(lambda: packet_traverse3(*args, **kw))
    bound, union = walk3_bounds(hit, counts, tally, kw, table_rows)
    shape_walk3(label, hit, counts, tally, bound, union, ms)
    return ms, plain_ms, err, bound, union


def shape_walk1(label, hit, counts, bound, ms, mhz):
    """The per-packet visits of a walk1 launch, its bound, how far the launch
    order's longest packets stretch it, and the cycles a visit costs the
    cluster (its time over the longest packet's visits: every packet is
    resident at once)."""
    import torch
    from fspt_tpu_torch.ops.traverse import PACKET
    g = hit.visits[::PACKET]
    if counts["node"] + counts["leaf"] != int(g.sum()) * PACKET:
        raise AssertionError(f"{label}: node + leaf visits differ from "
                             "the kernel's visits")
    q = torch.quantile(g.float(), torch.tensor([0.5, 0.99], device=g.device))
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    last, even = inorder_makespan(g.cpu(), sms)
    say("shape", launch=label, lanes=hit.visits.numel(), packets=g.numel(),
        packet_visits=int(g.sum()), mean=f"{g.float().mean().item():.2f}",
        p50=f"{q[0].item():.0f}", p99=f"{q[1].item():.0f}", max=int(g.max()),
        last_block_ends_at_visits=last, even_share_visits=f"{even:.0f}",
        node_packet_visits=counts["node"] // PACKET,
        leaf_packet_visits=counts["leaf"] // PACKET, **tested(counts),
        cluster_cycles_per_visit=f"{ms * 1e-3 * mhz * 1e6 / int(g.max()):.0f}",
        sm_mhz=mhz, **bound_fields(bound),
        share_of_bound=f"{bound['bound_ms'] / ms:.4f}")


def shape_walk5(label, hit, counts, bound, ms):
    """The per-walk visits of a walk5 launch, each program's longest walk
    against its mean (a program's walks meet at every burst vote), and its
    bound."""
    import torch
    from fspt_tpu_torch.scripts.traverse5_proto import (LANES, WALKS,
                                                        walk5_geometry)
    g = walk5_geometry(hit.visits.numel())
    walks = hit.visits[::LANES]
    # a program's walks (the pad walks of the last one left out)
    per = torch.cat([walks, walks.new_zeros(g["pad_blocks"])]).reshape(
        -1, WALKS).double()
    real = torch.cat([torch.ones_like(walks), walks.new_zeros(
        g["pad_blocks"])]).reshape(-1, WALKS).double()
    longest = per.max(1).values / (per.sum(1) / real.sum(1))
    q = [f"{v:.0f}" for v in torch.quantile(
        walks.double(), torch.tensor([0.5, 0.99], dtype=torch.float64,
                                     device=walks.device)).tolist()]
    say("shape", launch=label, lanes=hit.visits.numel(),
        programs=g["programs"], walks=walks.numel(),
        walk_visits_p50_p99_max=",".join(q + [f"{walks.max().item():.0f}"]),
        walk_visits_mean=f"{walks.double().mean().item():.2f}",
        node_walk_visits=counts["node"] // LANES,
        leaf_walk_visits=counts["leaf"] // LANES, **tested(counts),
        longest_walk_over_mean=f"{longest.mean().item():.3f}",
        **bound_fields(bound), share_of_bound=f"{bound['bound_ms'] / ms:.4f}")


def ptxas_summary(log):
    """One line per kernel entry of a `ptxas -v` log: template arguments,
    registers, spill stores/loads and stack frame."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            walk = re.search(r"walk_kernelILi(\d+)ELb(\d)ELb(\d)E", name)
            w4 = re.search(r"walk4_kernelILi(\d+)ELb(\d)E", name)
            w5 = re.search(r"walk5_kernelILi(\d+)ELb(\d)E", name)
            one = re.search(r"(dense_mt|micro)_kernelILi(\d+)E", name)
            w1 = re.search(r"walk1_kernelILb(\d)E", name)
            part = re.search(r"\d+(chain|leaf|fetch|leaf_begin|leaf_end)"
                             r"_kernel(?:ILi(\d+)E)?", name)
            if walk:
                tw, a, lc = walk.groups()
                entry = {"kernel": f"walk<width={tw},any={a},lanes={lc}>"}
            elif w4:
                entry = {"kernel": f"walk4<width={w4.group(1)},"
                                   f"any={w4.group(2)}>"}
            elif w5:
                entry = {"kernel": f"walk5<width={w5.group(1)},"
                                   f"any={w5.group(2)}>"}
            elif w1:
                entry = {"kernel": f"walk1<any={w1.group(1)}>"}
            elif one:
                arg = "T" if one.group(1) == "dense_mt" else "variant"
                entry = {"kernel": f"{one.group(1)}<{arg}={one.group(2)}>"}
            elif part:
                entry = {"kernel": f"micro {part.group(1)}"
                                   f"<{part.group(2) or ''}>"}
            else:
                entry = {"kernel": name}
            out.append(entry)
        elif entry is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m:
                entry["stack"], entry["spill_st"], entry["spill_ld"] = (
                    m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = m.group(1)
    return out


def check_launch(label, fn, ref_fn, args, kw, base_hit=None, lanes=False,
                 counts=None):
    """A captured launch, kernel against plain version: nearest, any-hit
    and per-ray-tmax-clipped runs bit-equal (and lane counts when asked),
    any-hit flags equal to the nearest hit's; returns (kernel ms, plain ms,
    max |diff| of t/u/v, nearest hit), both times of the nearest run.
    `counts`, a dict, receives the nearest run's node and leaf visits from
    the plain version."""
    import torch
    nodes, leaves, ro, rd, tmax = args
    dev = nodes.device
    n = ro.x.shape[0]
    run_k = lambda **x: fn(nodes, leaves, ro, rd, tmax, **{**kw, **x})
    run_p = lambda **x: ref_fn(nodes, leaves, ro, rd, tmax, **{**kw, **x})
    tally = {}
    # the plain version's time: its nearest run here, the launch `ms` times
    held = []
    plain_ms = cuda_ms(lambda: held.append(run_p(counts=tally)), 1,
                       warmup=False)
    hit, ref = run_k(), held[0]
    torch.cuda.synchronize()
    if counts is not None:
        counts.update({k: int(v) for k, v in tally.items()})
    err = compare(f"{label} nearest", hit, ref)
    anyk, anyp = run_k(any_hit=True), run_p(any_hit=True)
    compare(f"{label} any-hit", anyk, anyp)
    if not torch.equal(anyk.slot >= 0, hit.slot >= 0):
        raise AssertionError(f"{label}: any-hit occlusion flags differ "
                             "from the nearest hit's")
    # per-ray tmax clipping: each hit ray's tmax set to 0.2-0.7x or
    # 1.6-2.1x its nearest t (it must then miss, or keep its hit)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.rand(n, device=dev, generator=gen)
    frac = torch.where(u < 0.5, 0.2 + u, 1.1 + u)
    base_t = tmax if tmax is not None else torch.full_like(hit.t, 1e5)
    clip = torch.where(hit.slot >= 0, hit.t * frac, base_t)
    ck = fn(nodes, leaves, ro, rd, clip, **kw)
    cp = ref_fn(nodes, leaves, ro, rd, clip, **kw)
    compare(f"{label} clipped", ck, cp)
    kept = (hit.slot >= 0) & (frac > 1.0)
    if not (torch.equal(ck.slot[kept], hit.slot[kept])
            and bool((ck.slot[frac <= 1.0] < 0).all())):
        raise AssertionError(f"{label}: tmax clipping is inconsistent")
    extra = {}
    if lanes:
        lk, lp = run_k(lane_counts=True), run_p(lane_counts=True)
        compare(f"{label} lane counts", lk, lp)
        extra["mean_lane_count"] = f"{lk.visits.float().mean().item():.2f}"
    if base_hit is not None and not torch.equal(hit.slot, base_hit.slot):
        raise AssertionError(f"{label}: slots differ from the 8-wide "
                             "tables' hits")
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    check_stack_overflow(dev)
    ms = cuda_ms(run_k, 10)
    say("kernel", launch=label, lanes=n, hits=int((hit.slot >= 0).sum()),
        mean_visits=f"{hit.visits.float().mean().item():.2f}",
        bit_equal="slot,visits,t,u,v", any_hit="equal", clip="equal",
        **({"lane_counts": "equal"} if lanes else {}),
        **({"slots_as_8_wide": "equal"} if base_hit is not None else {}),
        **extra, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    return ms, plain_ms, err, hit


def timed_steps(r, steps, counter):
    """Reset `counter.launches`, run `steps` steps, read it back; returns
    (launches, samples, seconds, honest rays)."""
    s0 = r.stats
    counter.launches = 0
    r.step(steps)
    launches = counter.launches
    s1 = r.stats
    samples, seconds, rays = (s1[k] - s0[k]
                              for k in ("samples", "seconds", "rays"))
    return launches, samples, seconds, rays


def check_image(r, label, size):
    import numpy as np
    hdr = r.hdr_image()
    if hdr.shape != (size, size, 3) or not np.isfinite(hdr).all():
        raise AssertionError(f"{label} image is not a finite "
                             f"{size}x{size}x3 array")
    if not hdr.mean() > 0:
        raise AssertionError(f"{label} image is black")
    return hdr


# plain gradient descent on env_rgb and emit in phase 16.  The loss is a
# quadratic of those two fields (they enter no branch); on the card the
# loss along the first step's gradient, L0 - lr*a + lr**2*b/2, fitted from
# rates 25 and 50, has a = 0.050 and b = 0.014 (PERF_FINDINGS_ARCHIVE.md,
# the train step's Findings), so it falls for lr < 2a/b = 7 and most at
# 3.5.  1.0 leaves room for directions more curved than the gradient's.
TRAIN_LR = 1.0


def phase_train(scene, smi):
    """16. train (see the module docstring).  Raises on a failure."""
    import numpy as np
    from fspt_tpu_torch.ops.traverse import capture_launches
    import torch
    from fspt_tpu_torch import RenderConfig
    from fspt_tpu_torch.bench import bench_config
    from fspt_tpu_torch.core import integrator, rng
    from fspt_tpu_torch.core.vec import V3
    from fspt_tpu_torch.ops.traverse3 import packet_traverse3
    from fspt_tpu_torch.ops.traverse4 import packet_traverse4
    from fspt_tpu_torch.parallel.dist import (make_train_step,
                                              params_to_torch, split_params)
    from fspt_tpu_torch.runtime.renderer import CameraState
    size = 512
    n = size * size
    dev = torch.device("cuda:0")
    cfg = bench_config(size, 1)
    arrays = scene.to_torch(dev)
    cam = CameraState.from_config(scene.camera, dev)
    host = split_params(scene.arrays)
    cam_params = params_to_torch({"position": scene.camera.position,
                                  "direction": scene.camera.direction}, dev)
    base = rng.key(0)
    step = make_train_step(cfg, scene.meta)
    target = step.render(params_to_torch(host, dev), cam_params, arrays, cam,
                         base, 0)
    start_np = dict(host, env_rgb=tuple(0.5 * p for p in host["env_rgb"]),
                    emit=tuple(0.5 * p for p in host["emit"]))
    params = params_to_torch(start_np, dev)     # descends in place
    start = params_to_torch(start_np, dev)
    expected = integrator.traversal_launches(cfg, n, 1)
    losses, times = [], []
    for i in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = packet_traverse4.launches
        out = []
        t0 = time.perf_counter()
        # the step waits for its kernels (it reads the stack-overflow flag)
        calls = capture_launches(integrator, "packet_traverse4", lambda: (
            out.append(step(params, cam_params, arrays, cam, target, base,
                            0))))
        loss, grads, _ = out[0]
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
        launches = packet_traverse4.launches - before
        peak = torch.cuda.max_memory_allocated(dev)
        if not (launches == len(calls) == expected):
            raise AssertionError(f"train step {i}: traverse4 launched "
                                 f"{launches} times for {len(calls)} calls, "
                                 f"expected {expected}")
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"train step {i}: loss {losses[-1]}")
        if i == 0:
            g_env0 = [g.clone() for g in grads["env_rgb"]]
        say("train", step=i, loss=f"{losses[-1]:.6f}",
            ms=f"{times[-1]:.2f}", peak_mib=f"{peak / 2**20:.1f}",
            traverse4_launches=launches, calls=len(calls),
            expected_launches=expected)
        with torch.no_grad():
            for f in ("env_rgb", "emit"):
                for p, g in zip(params[f], grads[f]):
                    p -= TRAIN_LR * g
    if not losses[2] < losses[0]:
        raise AssertionError(f"train: the loss did not fall over 3 steps: "
                             f"{losses}")
    say("train_summary", size=f"{size}x{size}", bounces=cfg.bounces, spp=1,
        lr=TRAIN_LR, loss_0=f"{losses[0]:.6f}", loss_2=f"{losses[2]:.6f}",
        median_ms=f"{float(np.median(times)):.2f}",
        peak_mib=f"{peak / 2**20:.1f}", traverse4_launches_per_step=launches,
        card=repr(smi))

    # directional derivative along one seeded env direction at the start
    # point (every field as step 0 saw it), against a central difference
    # at the same RNG streams
    env0 = start["env_rgb"]
    h = 5e-3
    r = np.random.default_rng(16)
    v = [torch.from_numpy(r.standard_normal(p.shape[0]).astype(np.float32))
         .to(dev) for p in env0]
    ad = float(sum(torch.dot(g, w) for g, w in zip(g_env0, v)))

    def loss_at(sign):
        p = dict(start, env_rgb=V3(*(e.detach() + sign * h * w
                                     for e, w in zip(env0, v))))
        out = step.render(p, cam_params, arrays, cam, base, 0)
        # the step's loss, summed in float64 so that its rounding stays
        # far below the difference of the two sides
        return float(torch.mean((out - target).double() ** 2))

    fd = (loss_at(1.0) - loss_at(-1.0)) / (2.0 * h)
    rel = abs(ad - fd) / max(abs(ad), abs(fd), 1e-7)
    say("train_grad", texels=env0[0].shape[0], h=h, ad=f"{ad:.6g}",
        fd=f"{fd:.6g}", rel_err=f"{rel:.3g}", bound=2e-2)
    if not rel < 2e-2 or not abs(ad) > 1e-7:
        raise AssertionError(f"train: directional derivative {ad} against "
                             f"central difference {fd} (rel {rel})")

    # one step under the default configuration ("walk", fspt_walk3)
    wcfg = RenderConfig(width=size, height=size)
    wstep = make_train_step(wcfg, scene.meta)
    wtarget = wstep.render(params_to_torch(host, dev), cam_params, arrays,
                           cam, base, 0)
    before = packet_traverse3.launches
    t0 = time.perf_counter()
    wloss, _, _ = wstep(start, cam_params, arrays, cam, wtarget, base, 0)
    wloss = float(wloss)
    wms = (time.perf_counter() - t0) * 1e3
    wlaunches = packet_traverse3.launches - before
    wexpected = integrator.traversal_launches(wcfg, n, 1)
    if wlaunches != wexpected or not np.isfinite(wloss):
        raise AssertionError(f"walk train step: {wlaunches} walk3 launches "
                             f"(expected {wexpected}), loss {wloss}")
    say("train_walk", size=f"{size}x{size}", loss=f"{wloss:.6f}",
        ms=f"{wms:.2f}", walk3_launches=wlaunches,
        expected_launches=wexpected, card=repr(smi))


# ---- 6b: pcg4d -------------------------------------------------------------

# (launch, rows, lanes, key form, stream): the main path's shapes
PCG4D_SHAPES = (("bounce0", 11, 175_104, "row", 1),
                ("merged", 11, 191_488, "key_rows", 6),
                ("raygen", 4, 262_144, "offset", 0))


def phase_pcg4d(smi):
    """6b. pcg4d (see the module docstring).  Returns {launch: (kernel ms,
    plain ms, bound ms, plain ms as a graph replay)}.  Raises on a
    failure."""
    import numpy as np
    import torch
    from fspt_tpu_torch.core import rng
    from fspt_tpu_torch.ops.pcg4d import pcg4d_uniforms
    from fspt_tpu_torch.ops.traverse import H100_BYTES_PER_S
    dev = torch.device("cuda", torch.cuda.current_device())
    g = np.random.default_rng(19)
    key = rng.fold_in(rng.sample_key(rng.key(0), 0), 0)
    row = torch.from_numpy(key.astype(np.int64)).to(dev)
    out = {}
    for label, rows, n, form, stream in PCG4D_SHAPES:
        if form == "row":
            # the gid column of _take's (W, 5) int row gather
            block = torch.from_numpy(g.integers(0, 262_144, (n, 5))).to(
                dev, torch.int32)
            args, kw = (row, stream, (rows, n)), dict(lane_offset=block[:, 4])
            ids_bytes = 4 * n
        elif form == "key_rows":
            gid = torch.from_numpy(g.integers(0, 8 * 262_144, n)).to(
                dev, torch.int32)
            table = rng.key_rows_tensor(rng.key_rows_for(key, 8), dev)
            args = (row, stream, (rows, n))
            kw = dict(lane_offset=gid, key_rows=table, lanes_per_key=262_144)
            ids_bytes = 4 * n
        else:
            args, kw = (row, stream, (rows, n)), dict(device=dev)
            ids_bytes = 0
        before = pcg4d_uniforms.launches
        got = rng.stream_uniforms(*args, **kw)
        want = rng.stream_uniforms_reference(*args, **kw)
        torch.cuda.synchronize()
        if pcg4d_uniforms.launches != before + 1:
            raise AssertionError(f"pcg4d {label}: "
                                 f"{pcg4d_uniforms.launches - before} "
                                 "launches, not 1")
        if not torch.equal(got, want):
            raise AssertionError(f"pcg4d {label}: the kernel's uniforms "
                                 "differ from the plain chain's")
        ms = cuda_ms(lambda: rng.stream_uniforms(*args, **kw), 50,
                     queued=True)
        plain = cuda_ms(lambda: rng.stream_uniforms_reference(*args, **kw),
                        10)
        # the chain as a replayed sample step ran it: its device time alone
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rng.stream_uniforms_reference(*args, **kw)
        plain_graph = cuda_ms(graph.replay, 20)
        del graph
        nbytes = 4 * rows * n + ids_bytes
        bound = nbytes / H100_BYTES_PER_S * 1e3
        out[label] = (ms, plain, bound, plain_graph)
        say("pcg4d", launch=label, shape=f"{rows}x{n}", key=form,
            bit_equal=True, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            plain_graph_ms=f"{plain_graph:.4f}", bound_ms=f"{bound:.5f}",
            bound_by="bytes", bytes=nbytes,
            pct_of_bound=f"{100 * bound / ms:.1f}",
            speedup_over_graph=f"{plain_graph / ms:.1f}", card=repr(smi))
    return out


# ---- 17-19: refit and animate, view, profile ------------------------------

ANIM_FRAMES = 4          # frames 0-3 of the keyframes below, refit per frame


def anim_scene_dict(subdivisions=6):
    """make_bunny_standin_scene's scene (fspt_tpu_torch/testing.py) as a
    dict and its assets, with the bunny an animated prop keyframed over
    frames 0-3: a translation, a rotation about y and a uniform scale."""
    from fspt_tpu_torch.testing import (DictAssetLoader, checker_texture,
                                        icosphere_obj, quad_obj, sky_rgbe)
    loader = DictAssetLoader(
        texts={"bunny.obj": icosphere_obj(subdivisions),
               "floor.obj": quad_obj()},
        images={"sky.rgbe.png": sky_rgbe(1024, 512),
                "checker.png": checker_texture(256)})
    sd = {
        "environment": "sky.rgbe.png",
        "environmentTheta": 1.66,
        "cameraPos": [-0.751, 0.665, 1.82],
        "cameraDir": [0.304, -0.489, -0.818],
        "samples": 2000,
        "atlasRes": 256,
        "props": [
            {"path": "floor.obj", "scale": 4,
             "translate": [0, -0.75, 0], "diffuse": "checker.png",
             "metallicRoughness": [0.0, 0.5, 0.0], "normals": "flat"},
        ],
        "animated_props": [
            {"path": "bunny.obj", "scale": 0.35, "translate": [0.1, -0.2, 0],
             "diffuse": [1, 1, 1], "metallicRoughness": [0, 0.1, 0],
             "ior": 1.4, "normals": "smooth",
             "keyframes": [
                 {"frame": 0, "translate": [0.1, -0.2, 0.0], "scale": 0.35,
                  "rotate": [{"axis": [0, 1, 0], "angle": 0.0}]},
                 {"frame": ANIM_FRAMES - 1, "translate": [0.35, -0.12, -0.25],
                  "scale": 0.42,
                  "rotate": [{"axis": [0, 1, 0], "angle": 0.9}]}]},
        ],
    }
    return sd, loader


def phase_refit(cfg, smi):
    """17. refit and animate (see the module docstring).  Returns
    traverse4's launches a refit animation frame; raises on a failure."""
    import shutil

    import numpy as np
    from fspt_tpu_torch.ops.traverse import capture_launches
    import torch
    from fspt_tpu_torch.core import integrator, rng
    from fspt_tpu_torch.core.camera import generate_rays
    from fspt_tpu_torch.io.image import read_png
    from fspt_tpu_torch import RenderConfig
    from fspt_tpu_torch.ops.traverse import check_stack_overflow
    from fspt_tpu_torch.ops.traverse3 import packet_traverse3
    from fspt_tpu_torch.ops.traverse4 import (packet_traverse4,
                                              packet_traverse4_reference)
    from fspt_tpu_torch.runtime.animation import (render_animation,
                                                  scene_for_frame)
    from fspt_tpu_torch.runtime.layout import tile_order
    from fspt_tpu_torch.runtime.renderer import CameraState
    from fspt_tpu_torch.scene.refit import (aux_to, build_refit_aux,
                                            delta_affines, refit_arrays)
    from fspt_tpu_torch.scene.schema import (_prop_defaults, load_scene_dict,
                                             merge_scene_props)
    dev = torch.device("cuda:0")
    size = cfg.width
    n = size * size
    sd, loader = anim_scene_dict()
    props = lambda d: [_prop_defaults(p) for p in merge_scene_props(d)]
    walk_cfg = RenderConfig(width=size, height=size, bounces=cfg.bounces,
                            extra_refraction_iters=0, intersector="walk")

    t0 = time.perf_counter()
    base_sd = scene_for_frame(sd, 0)
    base = load_scene_dict(base_sd, loader, name="anim_base")
    aux = aux_to(build_refit_aux(base), dev)
    base_arrays = base.to_torch(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    meta = base.meta
    cam = CameraState.from_config(base.camera, dev)
    pixel_idx = torch.from_numpy(tile_order(size, size)).to(dev)
    k0 = rng.fold_in(rng.sample_key(rng.key(cfg.seed), 0), 0)
    o, d = generate_rays(cam.position, cam.direction, cam.fov_scale,
                         cam.focal_depth, cam.aperture, (size, size),
                         rng.stream_uniforms(k0, 0, (4, n), device=dev),
                         pixel_idx=pixel_idx)
    base_tri = torch.from_numpy(base.build["slot_tri"]).to(dev)
    pristine = base_arrays.pk_leaves.clone()
    # one refit under the profiler: its kernels and their device time
    from torch.profiler import ProfilerActivity, profile
    trace = os.path.join(OUT_DIR, "refit_trace.json")
    mats1, trans1 = delta_affines(props(base_sd), props(scene_for_frame(
        sd, 1)), sd.get("worldTransforms"))
    refit_arrays(base_arrays, meta, aux, mats1, trans1)      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        refit_arrays(base_arrays, meta, aux, mats1, trans1)
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    os.remove(trace)
    say("refit_setup", triangles=base.num_triangles,
        binary_nodes=base_arrays.node_left.shape[0],
        levels=len(aux.levels), slots=base_arrays.pk_leaves.shape[0]
        * base.leaf_size, node_rows=base_arrays.pk_nodes.shape[0],
        leaf_rows=base_arrays.pk_leaves.shape[0],
        compile_and_upload_s=f"{setup_s:.3f}", refit_kernels=len(kernels),
        refit_device_ms=f"{sum(e['dur'] for e in kernels) / 1e3:.3f}")

    for frame in range(ANIM_FRAMES):
        fsd = scene_for_frame(sd, frame)
        mats, trans = delta_affines(props(base_sd), props(fsd),
                                    sd.get("worldTransforms"))
        refit_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ra = refit_arrays(base_arrays, meta, aux, mats, trans)
            torch.cuda.synchronize()
            refit_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        rebuilt = load_scene_dict(fsd, loader, name=f"anim_f{frame}")
        ba = rebuilt.to_torch(dev)
        torch.cuda.synchronize()
        rebuild_ms = (time.perf_counter() - t0) * 1e3

        # traverse4 on the refit tables: the frame's primary launch and
        # its bounce-0 launch, kernel against plain version
        with torch.no_grad():
            calls = capture_launches(
                integrator, "packet_traverse4",
                lambda: integrator.trace_paths(ra, cfg, meta, o, d, k0))
        torch.cuda.synchronize()
        check_stack_overflow(dev)
        for label, (args, kw) in (("primary", calls[0]),
                                  ("bounce0", calls[1])):
            compare(f"refit frame {frame} {label}", packet_traverse4(
                *args, **kw), packet_traverse4_reference(*args, **kw))
        # the same primary rays on the refit and the rebuilt tables: the
        # same original triangles, up to coplanar or edge ties
        hr = integrator.intersect(ra, cfg, meta, o, d)
        hb = integrator.intersect(ba, cfg, rebuilt.meta, o, d)
        # walk3 (the --no-compact configuration) on the refit tables: the
        # slots traverse4 finds, up to ties at equal t
        walk_before = packet_traverse3.launches
        hw = integrator.intersect(ra, walk_cfg, meta, o, d)
        torch.cuda.synchronize()
        check_stack_overflow(dev)
        walk_ties = int((hw.slot != hr.slot).sum())
        if not (packet_traverse3.launches == walk_before + 1 and bool(
                ((hw.slot == hr.slot) | torch.isclose(
                    hw.t, hr.t, rtol=1e-6, atol=0.0)).all())):
            raise AssertionError(f"refit frame {frame}: walk3 and traverse4 "
                                 "disagree on the refit tables")
        reb_tri = torch.from_numpy(rebuilt.build["slot_tri"]).to(dev)
        tr = torch.where(hr.slot >= 0, base_tri[hr.slot.clamp(min=0)], -1)
        tb = torch.where(hb.slot >= 0, reb_tri[hb.slot.clamp(min=0)], -1)
        differ = tr != tb
        tie = differ & (tr >= 0) & (tb >= 0) & torch.isclose(
            hr.t, hb.t, rtol=1e-5, atol=0.0)
        apart = torch.nonzero(differ & ~tie).flatten()
        # a ray that differs at other t must differ by geometry, not by the
        # refit tree: refit's edges are M @ e where the rebuild's are
        # differences of transformed vertices, so a shared edge opens by
        # ulps and a ray exactly on it can leak through.  Its hit must be
        # the nearest of the refit tables' own triangles (brute force), and
        # the nearer of the two hits lie at an edge.
        bt, bs = brute_force(ra, torch.stack(list(o), -1)[apart],
                             torch.stack(list(d), -1)[apart],
                             torch.full((apart.numel(),), 1e5, device=dev))
        own = (bs == hr.slot[apart].long()) | torch.isclose(
            bt, hr.t[apart], rtol=1e-6, atol=0.0)
        near_r = (tr >= 0) & ((tb < 0) | (hr.t < hb.t))
        edge = lambda h: torch.minimum(torch.minimum(h.u, h.v),
                                       1.0 - h.u - h.v)
        at_edge = torch.where(near_r, edge(hr), edge(hb))[apart]
        # the refit's vertices against the rebuild's, triangle by triangle
        verts = lambda a, st: torch.zeros(
            (base.num_triangles, 3, 3), device=dev).index_copy_(
            0, st[st >= 0], torch.stack(
                [a.tri_v0, a.tri_v0 + a.tri_e1, a.tri_v0 + a.tri_e2],
                1)[st >= 0])
        vdiff = float((verts(ra, base_tri) - verts(ba, reb_tri)).abs().max())
        say("refit", frame=frame, refit_ms=f"{float(np.median(refit_ms)):.3f}",
            refit_first_ms=f"{refit_ms[0]:.3f}",
            rebuild_ms=f"{rebuild_ms:.1f}", primary_rays=n,
            hits=int((tr >= 0).sum()), differ=int(differ.sum()),
            ties=int(tie.sum()), leaks=apart.numel(),
            leaks_own_nearest=int(own.sum()),
            leak_max_edge_bary=(f"{float(at_edge.max()):.2e}"
                                if apart.numel() else "-"),
            vertex_max_abs_diff=f"{vdiff:.2e}",
            visits_refit=f"{hr.visits.float().mean().item():.3f}",
            visits_rebuild=f"{hb.visits.float().mean().item():.3f}",
            kernel_vs_plain="bit-equal primary,bounce0",
            walk3_vs_traverse4=f"equal but {walk_ties} ties",
            stack_flags="clear", card=repr(smi))
        if not (bool(own.all()) and apart.numel() <= n // 10000
                and vdiff < 1e-5):
            raise AssertionError(
                f"refit frame {frame}: {apart.numel()} rays hit other "
                f"triangles at other t than on the rebuilt tables (1e-4 of "
                f"the rays allowed), {int((~own).sum())} of them not the "
                f"refit tables' nearest; vertices {vdiff} apart")
        del ra, ba, rebuilt
    if not torch.equal(base_arrays.pk_leaves, pristine):
        raise AssertionError("refit wrote into the base frame's tables")

    # render_animation: refit and rebuild over the same 3 frames, 8 spp a
    # frame (one batch of cfg.batch_spp = 8, a checkpoint after it)
    expected = integrator.traversal_launches(cfg, n, cfg.batch_spp)
    frames = {}
    for refit in (True, False):
        out_dir = os.path.join(OUT_DIR,
                               "anim_refit" if refit else "anim_rebuild")
        shutil.rmtree(out_dir, ignore_errors=True)
        packet_traverse4.launches = 0
        marks = [(time.perf_counter(), 0)]
        spp = []

        def on_frame(frame, path, r):
            marks.append((time.perf_counter(), packet_traverse4.launches))
            spp.append(int(float(r.count)))

        paths = render_animation(sd, loader, out_dir, range(3), config=cfg,
                                 samples=cfg.batch_spp, checkpoint_every=1,
                                 on_frame=on_frame, name="anim",
                                 refit=refit, device="cuda")
        ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
        launches = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
        if launches != [expected] * 3 or spp != [cfg.batch_spp] * 3:
            raise AssertionError(f"animate refit={refit}: traverse4 launched "
                                 f"{launches} times a frame (expected "
                                 f"{expected}), samples {spp}")
        frames[refit] = paths
        per_frame = launches[0]
        say("animate_frames", refit=refit, size=f"{size}x{size}",
            bounces=cfg.bounces, spp_per_frame=cfg.batch_spp,
            ms_per_frame=",".join(f"{x:.1f}" for x in ms),
            mean_ms_per_frame_after_first=f"{float(np.mean(ms[1:])):.1f}",
            traverse4_launches_per_frame=launches[0],
            expected_launches=expected, card=repr(smi))
    worst_mean = worst_p99 = 0.0
    for pa, pb in zip(frames[True], frames[False]):
        diff = np.abs(read_png(pa) - read_png(pb))
        worst_mean = max(worst_mean, float(diff.mean()))
        worst_p99 = max(worst_p99, float(np.quantile(diff, 0.99)))
    say("animate", frames=3, png_mean_abs_diff=f"{worst_mean:.6f}",
        png_mean_bound=f"{2 / 255:.6f}", png_p99_abs_diff=f"{worst_p99:.6f}",
        png_p99_bound=f"{4 / 255:.6f}",
        pngs=os.path.relpath(os.path.dirname(frames[True][0]), HERE),
        card=repr(smi))
    if not (worst_mean < 2 / 255 and worst_p99 <= 4 / 255):
        raise AssertionError(f"animate: refit frames differ from rebuild "
                             f"frames by mean {worst_mean}, p99 {worst_p99}")

    # the command line, in a subprocess: a tiny keyframed scene, 2 frames
    from fspt_tpu_torch.testing import icosphere_obj, quad_obj
    cli_dir = os.path.join(OUT_DIR, "cli_animate")
    shutil.rmtree(cli_dir, ignore_errors=True)
    os.makedirs(cli_dir)
    for name, text in (("mesh.obj", icosphere_obj(2)),
                       ("floor.obj", quad_obj())):
        with open(os.path.join(cli_dir, name), "w") as f:
            f.write(text)
    scene_path = os.path.join(cli_dir, "scene.json")
    with open(scene_path, "w") as f:
        json.dump({"environment": [[0.2, 0.2, 0.3], [0.9, 0.9, 0.8]],
                   "cameraPos": [0, 0.4, 2.2],
                   "cameraDir": [0, -0.18, -0.98],
                   "props": [{"path": "floor.obj", "scale": 6,
                              "translate": [0, -0.5, 0],
                              "diffuse": [0.6, 0.6, 0.6]}],
                   "animated_props": [
                       {"path": "mesh.obj", "scale": 0.5,
                        "diffuse": [0.8, 0.3, 0.2],
                        "keyframes": [
                            {"frame": 0, "translate": [-0.4, 0, 0]},
                            {"frame": 1, "translate": [0.4, 0.1, 0],
                             "rotate": [{"axis": [0, 1, 0],
                                         "angle": 0.7}]}]}]}, f)
    for flags in ([], ["--refit"]):
        out = os.path.join(cli_dir, "frames_refit" if flags else "frames")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fspt_tpu_torch", "animate", scene_path,
             "--end", "2", "--res", "64", "--samples", "4", *flags,
             "-o", out], cwd=HERE, capture_output=True, text=True,
            timeout=300)
        pngs = sorted(f for f in os.listdir(out)) if os.path.isdir(out) \
            else []
        if proc.returncode != 0 or pngs != ["frame_00000.png",
                                            "frame_00001.png"]:
            raise AssertionError(f"CLI animate {flags} failed "
                                 f"({proc.returncode}, {pngs}):\n"
                                 f"{proc.stderr}")
        say("cli_animate", flags=" ".join(flags) or "(default)",
            rc=proc.returncode, seconds=f"{time.perf_counter() - t0:.2f}",
            frames=len(pngs), out=os.path.relpath(out, HERE))
    return per_frame


def _next_frame(v, last_id, deadline, want=lambda meta: True):
    """The first frame after `last_id` that `want` accepts, by the
    deadline."""
    while time.perf_counter() < deadline:
        png, meta, fid = v.frame_png()
        if fid != last_id and png:
            if want(meta):
                return png, meta, fid
            last_id = fid
        time.sleep(0.01)
    raise AssertionError("view: no frame by the phase's deadline")


def phase_view(scene, cfg, smi):
    """18. view (see the module docstring).  Returns traverse4's launches
    over the headless part; raises on a failure."""
    import socket
    import urllib.request

    import torch
    from fspt_tpu_torch.ops.traverse4 import packet_traverse4
    from fspt_tpu_torch.runtime.viewer import InteractiveViewer
    t_phase = time.perf_counter()
    packet_traverse4.launches = 0
    v = InteractiveViewer(scene, cfg, device="cuda")
    try:
        v.start()
        png, meta, fid = _next_frame(v, -1, time.perf_counter() + 8)
        first_s = time.perf_counter() - t_phase
        # a drag: look events at 20 Hz from a thread of their own, as the
        # page posts them, until the loop has served previews
        dragging, event_ms = threading.Event(), []

        def drag():
            while dragging.is_set():
                t0 = time.perf_counter()
                v.handle_event({"type": "look", "dx": 2, "dy": 1})
                event_ms.append((time.perf_counter() - t0) * 1e3)
                time.sleep(0.05)

        dragging.set()
        dragger = threading.Thread(target=drag, daemon=True)
        dragger.start()
        try:
            deadline = time.perf_counter() + 6
            png, meta, fid = _next_frame(v, fid, deadline,
                                         lambda m: m["preview"])
            previews = 1
            for _ in range(4):                   # a few more while moving
                png, meta, fid = _next_frame(v, fid, deadline)
                previews += meta["preview"]
        finally:
            dragging.clear()
            dragger.join(timeout=2)
        # release: autofocus, then progressive frames
        v.handle_event({"type": "moveend"})
        png, meta, fid = _next_frame(
            v, fid, time.perf_counter() + 4,
            lambda m: not m["preview"] and m["samples"] >= 2)
        settled = meta["samples"]
        # envTheta restarts the accumulation
        v.handle_event({"type": "slider", "name": "envTheta", "value": 2.0})
        png, meta, fid = _next_frame(
            v, fid, time.perf_counter() + 4,
            lambda m: not m["preview"] and m["samples"] == cfg.batch_spp)
        theta = (float(v.renderer.arrays.env_theta),
                 float(v.preview.arrays.env_theta))
        if theta != (2.0, 2.0):
            raise AssertionError(f"view: env_theta {theta} after the slider")
    finally:
        v.stop()
    if v._thread.is_alive():
        raise AssertionError("view: the render loop did not stop")
    launches = packet_traverse4.launches
    captures = (v.renderer.stats["graph_captures"],
                v.preview.stats["graph_captures"])
    # a frame is one step of the renderer that made it
    frames = lambda r: r.stats["samples"] / r.cfg.batch_spp
    ms = lambda r: r.stats["seconds"] * 1e3 / frames(r)
    say("view", size=f"{cfg.width}x{cfg.height}",
        preview=f"{v.preview.cfg.width}x{v.preview.cfg.height}",
        first_frame_s=f"{first_s:.3f}",
        full_frames=f"{frames(v.renderer):.0f}",
        ms_per_full_frame=f"{ms(v.renderer):.1f}",
        preview_frames=f"{frames(v.preview):.0f}",
        previews_of_5_while_moving=previews, look_events=len(event_ms),
        max_event_ms=f"{max(event_ms):.2f}",
        ms_per_preview_frame=f"{ms(v.preview):.1f}",
        settled_samples=settled, restart_samples=meta["samples"],
        traverse4_launches=launches,
        graph_captures=f"{captures[0]},{captures[1]}", card=repr(smi))
    if not launches > 0:
        raise AssertionError("view: traverse4 was never launched")
    if captures != (1, 1):
        raise AssertionError(f"view: graph captures {captures}, not one "
                             "each before the first event")

    # the HTTP routes, on a free loopback port
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    threading.Thread(target=v.serve, kwargs=dict(port=port),
                     daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.perf_counter() + 4
        while True:
            try:
                page = urllib.request.urlopen(url + "/", timeout=2).read()
                break
            except OSError:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(0.1)
        req = urllib.request.Request(
            url + "/input", method="POST",
            data=json.dumps({"type": "zoom", "delta": 100}).encode())
        status = urllib.request.urlopen(req, timeout=5).status
        _next_frame(v, -1, time.perf_counter() + 2)
        r = urllib.request.urlopen(url + "/frame", timeout=5)
        body, ctype = r.read(), r.headers["Content-Type"]
        meta = json.loads(r.headers["X-Meta"])
    finally:
        v.stop()
    if not (b"fspt_tpu viewer" in page and status == 204
            and ctype == "image/png" and body[:4] == b"\x89PNG"):
        raise AssertionError(f"view HTTP: page {len(page)} B, POST "
                             f"{status}, frame {ctype} {len(body)} B")
    say("view_http", get_page_bytes=len(page), post_input=status,
        frame_type=ctype, frame_bytes=len(body), x_meta=json.dumps(meta),
        phase_s=f"{time.perf_counter() - t_phase:.2f}")
    del v
    torch.cuda.synchronize()
    return launches


def phase_profile(scene, cfg, smi):
    """19. profile (see the module docstring).  Raises on a failure."""
    import glob
    import gzip
    import shutil

    import torch
    from fspt_tpu_torch import Renderer
    from fspt_tpu_torch.ops.traverse4 import packet_traverse4
    r = Renderer(scene, cfg, device="cuda")
    r.step()                                      # warm-up (eager)
    r.step()                                      # the graph's capture
    logdir = os.path.join(OUT_DIR, "profile")
    shutil.rmtree(logdir, ignore_errors=True)
    packet_traverse4.launches = 0
    t0 = time.perf_counter()
    r.profile_trace(logdir, 1)
    profiled_s = time.perf_counter() - t0
    launches = packet_traverse4.launches
    path, = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    mb = os.path.getsize(path) / 1e6
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    step, = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "fspt.step"]
    traverse = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "fspt.traverse"]
    replay = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == "fspt.replay"]
    walk4 = [e for e in kernels if "walk4_kernel" in e["name"]]
    busy_us = sum(e["dur"] for e in kernels)
    names = {}
    for e in kernels:
        names[e["name"]] = names.get(e["name"], 0) + e["dur"]
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    # the trace is tens of MB; keep it compressed
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    say("profile", size=f"{cfg.width}x{cfg.height}", spp=cfg.batch_spp,
        bounces=cfg.bounces, kernel_events=len(kernels),
        traverse4_events=len(walk4), traverse4_launches=launches,
        traverse_spans=len(traverse), replay_spans=len(replay),
        kernel_ms=f"{busy_us / 1e3:.3f}",
        traverse4_ms=f"{sum(e['dur'] for e in walk4) / 1e3:.3f}",
        step_wall_ms=f"{step['dur'] / 1e3:.3f}",
        busy_share=f"{busy_us / step['dur']:.4f}",
        profiled_s=f"{profiled_s:.2f}", trace_mb=f"{mb:.1f}",
        trace=os.path.relpath(path + ".gz", HERE), card=repr(smi))
    for name, us in top:
        say("profile_top", kernel=repr(name[:90]), ms=f"{us / 1e3:.3f}",
            share_of_kernel_time=f"{us / busy_us:.4f}")
    if not (walk4 and len(walk4) == launches > 0):
        raise AssertionError(f"profile: {len(walk4)} traverse4 kernel "
                             f"events for {launches} launches in the trace")
    # a replayed step: one fspt.replay span, and its phases run on the
    # device alone, so no fspt.traverse span
    if len(replay) != 1 or traverse:
        raise AssertionError(f"profile: {len(replay)} fspt.replay and "
                             f"{len(traverse)} fspt.traverse spans in the "
                             "trace of a replayed step")
    del r
    torch.cuda.synchronize()


# ---- 20: dist -------------------------------------------------------------

DIST_SHARDS = 8          # the [dist_render] mesh, held by this process
DIST_DEADLINE_S = 150    # a subprocess job of [dist_group] / [dist_nccl]


def dist_cfg(batch_spp):
    """The bench configuration without the cross-sample batch (the
    sharded step has none, as the reference's), under the default
    compaction schedule: the bench's (1.5, 11, ...) is set for batch_spp x
    N lanes, and on one sample's N it drops lanes by Russian roulette at
    bounce 0 (175,104 lanes for ~177,860 primary hits), which reweights
    every lane of the launch, so no per-pixel comparison of a mesh with one
    device could hold."""
    from fspt_tpu_torch import RenderConfig
    return RenderConfig(width=512, height=512, bounces=8,
                        extra_refraction_iters=0, batch_spp=batch_spp,
                        compact=True, sort_state=True, intersector="split",
                        nee_env_nearest=True, escape_env_nearest=True)


def dist_render(scene, cfg, mesh, steps):
    """`steps` sharded sample steps over `mesh` -> (the gathered (3, N)
    image in pixel-id order, the per-step (size,) shard_rays, ms a step)."""
    import numpy as np
    import torch
    from fspt_tpu_torch.core import rng
    from fspt_tpu_torch.parallel.dist import (gather_accum,
                                              make_sharded_sample_step,
                                              shard_accum)
    from fspt_tpu_torch.runtime.renderer import CameraState
    dev = mesh.device
    step = make_sharded_sample_step(mesh, cfg, scene.meta)
    arrays = scene.to_torch(dev)
    cam = CameraState.from_config(scene.camera, dev)
    n = cfg.width * cfg.height
    accum = shard_accum(torch.zeros((3, n)), mesh)
    count = torch.zeros((), device=dev)
    rays, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        # the step waits for its kernels (it reads the stack-overflow flag)
        accum, count, shard_rays = step(arrays, cam, accum, count,
                                        rng.key(cfg.seed), i)
        ms.append((time.perf_counter() - t0) * 1e3)
        rays.append(shard_rays.cpu().numpy())
    img = np.zeros((3, n), np.float32)
    img[:, step.pixel_order] = gather_accum(accum, mesh).cpu().numpy()
    return img, rays, ms


def dist_train(scene, cfg, mesh):
    """One train step over `mesh` as phase 16 takes its first: the target
    the step's own render at the scene's parameters, env_rgb and emit at
    half of theirs -> [loss, every gradient leaf] as numpy."""
    from fspt_tpu_torch.core import rng
    from fspt_tpu_torch.parallel.dist import (make_train_step,
                                              params_to_torch, split_params)
    from fspt_tpu_torch.runtime.renderer import CameraState
    dev = mesh.device
    step = make_train_step(cfg, scene.meta, mesh=mesh)
    arrays = scene.to_torch(dev)
    cam = CameraState.from_config(scene.camera, dev)
    host = split_params(scene.arrays)
    cam_params = params_to_torch({"position": scene.camera.position,
                                  "direction": scene.camera.direction}, dev)
    target = step.render(params_to_torch(host, dev), cam_params, arrays, cam,
                         rng.key(0), 0)
    start = dict(host, env_rgb=tuple(0.5 * p for p in host["env_rgb"]),
                 emit=tuple(0.5 * p for p in host["emit"]))
    loss, grads, cam_grads = step(params_to_torch(start, dev), cam_params,
                                  arrays, cam, target, rng.key(0), 0)
    return [loss.cpu().numpy()] + [
        p.cpu().numpy() for g in list(grads.values())
        + list(cam_grads.values()) for p in (g if isinstance(g, tuple)
                                             else (g,))]


def dist_worker(port, rank, world, backend, outdir):
    """A rank of a [dist_group] / [dist_nccl] job (`python3 chip_smoke.py
    --dist-worker PORT RANK WORLD BACKEND OUTDIR`): the sharded 512² step
    over the global mesh, its image gathered, and one train step; written
    to OUTDIR/rank<RANK>.npz for the parent to compare.  Imports torch and
    fspt_tpu_torch only."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist
    from fspt_tpu_torch.parallel import multihost
    from fspt_tpu_torch.testing import make_bunny_standin_scene
    rank, world = int(rank), int(world)
    if world > 1:
        multihost.initialize(f"127.0.0.1:{port}", world, rank,
                             backend=backend)
    else:
        # initialize() leaves a one-process job without a group; this one
        # wants the group, to run the collectives on one rank
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=1, rank=0)
    try:
        scene = make_bunny_standin_scene(subdivisions=6)
        mesh = multihost.global_mesh()
        if mesh.size != world or mesh.group is None:
            raise AssertionError(f"rank {rank}: mesh {mesh}")
        img, rays, _ = dist_render(scene, dist_cfg(1), mesh, 1)
        train = dist_train(scene, dist_cfg(1), mesh)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), img, rays[0],
                 *train)
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("the dist worker imported jax")


def spawn_dist(world, backend, outdir):
    """Start a job of `world` dist_worker processes on a free loopback
    port; returns the processes."""
    import socket
    os.makedirs(outdir, exist_ok=True)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for rank in range(world):
        with open(os.path.join(outdir, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker",
                 str(port), str(rank), str(world), backend, outdir],
                cwd=HERE, stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_dist(label, procs, outdir, deadline):
    """Wait for a job by `deadline` (killing every process past it) and
    return each rank's results; raises if a rank failed or was late."""
    import numpy as np
    late = False
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            late = True
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if late or failed:
        logs = ""
        for r in range(len(procs)):
            with open(os.path.join(outdir, f"rank{r}.log")) as f:
                logs += f"--- rank {r}\n" + f.read()[-3000:]
        raise AssertionError(f"{label}: ranks {failed} failed, late={late}"
                             f"\n{logs}")
    out = []
    for r in range(len(procs)):
        with np.load(os.path.join(outdir, f"rank{r}.npz")) as z:
            out.append([z[f"arr_{i}"] for i in range(len(z.files))])
    return out


def check_dist(label, ranks, ref, smi, **kv):
    """Every rank's image bit-equal to the one-process mesh's and its
    shard_rays equal; its loss and finite gradients within rtol 1e-5 of
    the one-process step's (the backward's scatter-adds are not ordered on
    the card), and its non-finite gradients where the one-process step has
    them, with the same values."""
    import numpy as np
    worst = 0.0
    for r, res in enumerate(ranks):
        if not (np.array_equal(res[0], ref[0])
                and np.array_equal(res[1], ref[1])):
            raise AssertionError(
                f"{label}: rank {r}'s image is not the one-process mesh's "
                f"(max |diff| {np.abs(res[0] - ref[0]).max()}, rays "
                f"{res[1]} against {ref[1]})")
        for i, (a, b) in enumerate(zip(res[2:], ref[2:])):
            fin = np.isfinite(b)
            if not (np.array_equal(np.isfinite(a), fin)
                    and np.array_equal(a[~fin], b[~fin], equal_nan=True)
                    and np.allclose(a[fin], b[fin], rtol=1e-5, atol=1e-9)):
                raise AssertionError(f"{label}: rank {r}'s train step "
                                     f"differs from the one-process mesh's "
                                     f"at leaf {i} (the loss is leaf 0)")
            nz = fin & (b != 0)
            if nz.any():
                worst = max(worst, float(
                    (np.abs(a[nz] - b[nz]) / np.abs(b[nz])).max()))
    say(label, ranks=len(ranks), image="bit-equal", shard_rays="equal",
        loss=f"{float(ranks[0][2]):.6f}", train_max_rel_diff=f"{worst:.3g}",
        train_bound="rtol 1e-5",
        nonfinite_gradients=sum(int((~np.isfinite(b)).sum())
                                for b in ref[3:]), **kv, card=repr(smi))


def phase_dist(scene, smi):
    """20. dist (see the module docstring).  Returns the traverse4 and the
    walk3 launches of a sharded step.  Raises on a failure."""
    import shutil
    import tempfile

    import numpy as np
    from fspt_tpu_torch.ops.traverse import capture_launches
    import torch
    from fspt_tpu_torch import RenderConfig, Renderer
    from fspt_tpu_torch.core import integrator
    from fspt_tpu_torch.ops.traverse3 import (packet_traverse3,
                                              packet_traverse3_reference)
    from fspt_tpu_torch.ops.traverse4 import (packet_traverse4,
                                              packet_traverse4_reference)
    from fspt_tpu_torch.parallel.dist import make_mesh
    from fspt_tpu_torch.parallel.scaling import measure_scaling
    t_phase = time.perf_counter()
    cfg = dist_cfg(2)
    n = cfg.width * cfg.height
    local = n // DIST_SHARDS
    mesh = make_mesh(DIST_SHARDS)

    # [dist_render]: the 8-shard mesh against Renderer.step, 2 steps each
    r = Renderer(scene, cfg, device="cuda")
    r.step(2)
    single = np.zeros((3, n), np.float32)
    single[:, r.pixel_idx.cpu().numpy()] = r.accum.cpu().numpy()
    packet_traverse4.launches = 0
    held = []
    t4_calls = capture_launches(integrator, "packet_traverse4", lambda: (
        held.append(dist_render(scene, cfg, mesh, 2))))
    img, rays, ms = held[0]
    launches = packet_traverse4.launches // 2
    t4_primary = t4_calls[0]        # shard 0's primary rays, sample 0
    del t4_calls
    expected = DIST_SHARDS * integrator.traversal_launches(
        cfg, local, cfg.batch_spp)
    close = np.isclose(img, single, rtol=1e-5, atol=1e-6)
    total = float(sum(x.sum() for x in rays))
    last = rays[-1]
    balance = float(last.sum() / (DIST_SHARDS * last.max()))
    say("dist_render", shards=DIST_SHARDS, size=f"{cfg.width}x{cfg.height}",
        spp_per_step=cfg.batch_spp, steps=2,
        bit_equal_share=f"{float(np.mean(img == single)):.6f}",
        within_bound_share=f"{float(close.mean()):.6f}",
        max_abs_diff=f"{float(np.abs(img - single).max()):.3g}",
        bound="rtol 1e-5 atol 1e-6", shard_rays_sum=f"{total:.0f}",
        renderer_rays=f"{r.stats['rays']:.0f}",
        balance_efficiency=f"{balance:.4f}", traverse4_launches=launches,
        expected_launches=expected, ms_per_step=f"{ms[1]:.2f}",
        first_step_ms=f"{ms[0]:.2f}", card=repr(smi))
    if not close.all():
        raise AssertionError(f"dist_render: {int((~close).sum())} values "
                             "outside rtol 1e-5, atol 1e-6 of Renderer.step")
    if not abs(total - r.stats["rays"]) <= 1e-6 * r.stats["rays"]:
        raise AssertionError(f"dist_render: shard rays {total} against the "
                             f"renderer's {r.stats['rays']}")
    if launches * 2 != packet_traverse4.launches or launches != expected:
        raise AssertionError(f"dist_render: traverse4 launched "
                             f"{packet_traverse4.launches} times in 2 steps, "
                             f"expected {expected} a step")
    del r

    # one 8-shard step under the default "walk", fspt_walk3's launches
    wcfg = RenderConfig(width=cfg.width, height=cfg.height, bounces=8,
                        extra_refraction_iters=0, intersector="walk")
    packet_traverse3.launches = 0
    held = []
    w_calls = capture_launches(integrator, "packet_traverse3", lambda: (
        held.append(dist_render(scene, wcfg, mesh, 1))))
    wimg, _, wms = held[0]
    walk_launches = packet_traverse3.launches
    w_primary = w_calls[0]
    del w_calls
    wexpected = DIST_SHARDS * integrator.traversal_launches(wcfg, local, 1)
    r = Renderer(scene, wcfg, device="cuda")
    r.step(1)
    wsingle = np.zeros((3, n), np.float32)
    wsingle[:, r.pixel_idx.cpu().numpy()] = r.accum.cpu().numpy()
    del r
    wclose = np.isclose(wimg, wsingle, rtol=1e-5, atol=1e-6)
    say("dist_walk", shards=DIST_SHARDS, size=f"{wcfg.width}x{wcfg.height}",
        spp=1, bit_equal_share=f"{float(np.mean(wimg == wsingle)):.6f}",
        within_bound_share=f"{float(wclose.mean()):.6f}",
        max_abs_diff=f"{float(np.abs(wimg - wsingle).max()):.3g}",
        bound="rtol 1e-5 atol 1e-6", walk3_launches=walk_launches,
        expected_launches=wexpected, ms_per_step=f"{wms[0]:.2f}",
        card=repr(smi))
    if not wclose.all():
        raise AssertionError(f"dist_walk: {int((~wclose).sum())} values "
                             "outside rtol 1e-5, atol 1e-6 of Renderer.step "
                             "under \"walk\"")
    if walk_launches != wexpected:
        raise AssertionError(f"dist_walk: {walk_launches} walk3 launches "
                             f"(expected {wexpected})")

    # shard 0's primary launch of each kernel at the shard's shapes, held
    # bit for bit to its plain version (after the counts were read: these
    # launches are not the path's)
    check_launch("traverse4 dist shard0 primary", packet_traverse4,
                 packet_traverse4_reference, *t4_primary)
    check_launch("walk3 dist shard0 primary", packet_traverse3,
                 packet_traverse3_reference, *w_primary)
    del t4_primary, w_primary

    # [dist_scaling]
    report = measure_scaling(scene, dist_cfg(1), device_counts=(1, 2, 4, 8),
                             steps=1, warmup=1)
    if [p.n_devices for p in report.points] != [1, 2, 4, 8]:
        raise AssertionError(f"dist_scaling: points {report.points}")
    print(report.table(), flush=True)
    say("dist_scaling", shards="1,2,4,8",
        balance_efficiency=",".join(f"{p.balance_efficiency:.4f}"
                                    for p in report.points),
        ms_per_step=",".join(f"{p.seconds * 1e3:.2f}"
                             for p in report.points),
        rays_per_step=",".join(f"{p.rays:.0f}" for p in report.points),
        wall_clock="informational: the shards of one process run one after "
        "another on one card", card=repr(smi))

    # [dist_group], [dist_nccl]: jobs of ranks in subprocesses, all at
    # once; this process makes their one-process references meanwhile
    work = tempfile.mkdtemp(prefix="dist_",
                            dir=os.path.join(HERE, "fspt_tpu_torch",
                                             "_build"))
    cards = torch.cuda.device_count()
    jobs = {"dist_group": (2, "gloo"), "dist_nccl": (1, "nccl")}
    if cards >= 2:
        jobs["dist_nccl_cross_card"] = (2, "nccl")
    deadline = time.perf_counter() + DIST_DEADLINE_S
    procs = {label: spawn_dist(world, backend, os.path.join(work, label))
             for label, (world, backend) in jobs.items()}
    try:
        refs = {}
        for size in (1, 2):
            img, rays, _ = dist_render(scene, dist_cfg(1), make_mesh(size),
                                       1)
            refs[size] = [img, rays[0]] + dist_train(scene, dist_cfg(1),
                                                     make_mesh(size))
        for label, (world, backend) in jobs.items():
            ranks = finish_dist(label, procs[label],
                                os.path.join(work, label), deadline)
            check_dist(label, ranks, refs[world], smi, backend=backend,
                       mesh=world,
                       cards=min(world, cards) if backend == "nccl" else 1)
    finally:
        for p in (p for job in procs.values() for p in job):
            if p.poll() is None:
                p.kill()
                p.wait()
    if cards < 2:
        print(json.dumps({"cards": cards, "cross_card": "not run"}),
              flush=True)
    shutil.rmtree(work)
    say("dist_summary", phase_s=f"{time.perf_counter() - t_phase:.2f}",
        cards=cards)
    return launches, walk_launches


# ---- 21: perf_phase --------------------------------------------------------

def phase_perf(scene, smi):
    """21. perf_phase (see the module docstring).  Returns {kernel name:
    its launches over the phase's run of perf_phase.main}.  Raises on a
    failure."""
    import torch
    from fspt_tpu_torch.bench import bench_config
    from fspt_tpu_torch.ops.traverse3 import (packet_traverse3,
                                              packet_traverse3_reference)
    from fspt_tpu_torch.ops.traverse4 import (packet_traverse4,
                                              packet_traverse4_reference)
    from fspt_tpu_torch.scripts import perf_phase
    t_phase = time.perf_counter()
    launches = {}
    # the plain versions' runs of every launch only under "split" (~5 s):
    # under "walk" they take ~45 s, and the standalone script gives them
    for name, cfg, fn, ref_fn, plain in (
            ("traverse4", bench_config(512, 1), packet_traverse4,
             packet_traverse4_reference, True),
            ("walk3", None, packet_traverse3, packet_traverse3_reference,
             False)):
        t0 = time.perf_counter()
        fn.launches = 0
        res = perf_phase.main(cfg, "cuda", scene=scene, plain=plain)
        launches[name] = fn.launches
        if not launches[name] > res["launches"] > 0:
            raise AssertionError(f"perf_phase: {name} launched "
                                 f"{launches[name]} times")
        main_s = time.perf_counter() - t0
        # the captured bounce-0 launch, and the replay's tally of it
        args, kw = res["calls"][1]
        counts = {}
        check_launch(f"{name} perf_phase bounce0", fn, ref_fn, args, kw,
                     counts=counts)
        if plain and counts != res["table"][1]["counts"]:
            raise AssertionError(f"perf_phase: {name} bounce-0 tally "
                                 f"{res['table'][1]['counts']} != {counts}")
        full, parts = (res["totals"][p] for p in ("trace_paths",
                                                  "sum_of_phases"))
        say("phase_summary", kernel=name, launches=launches[name],
            capture_launches=res["launches"],
            trace_paths_kernels=full["kernels"],
            sum_of_phases_kernels=parts["kernels"],
            trace_paths_device_ms=f"{full['device_ms']:.3f}",
            trace_paths_wall_ms=f"{full['wall_ms']:.3f}",
            main_s=f"{main_s:.2f}", card=repr(smi))
    torch.cuda.synchronize()
    say("perf_phase", phase_s=f"{time.perf_counter() - t_phase:.2f}")
    return launches


# ---- 22: graph ------------------------------------------------------------

GRAPH_STEPS = 6          # phase 22's timed steps of each kind, in turns


def phase_graph(scene, smi):
    """22. graph (see the module docstring).  Raises on a failure."""
    import types

    import torch
    from fspt_tpu_torch import Renderer
    from fspt_tpu_torch.__main__ import _config
    from fspt_tpu_torch.bench import bench_config
    from fspt_tpu_torch.core import integrator
    from fspt_tpu_torch.ops.pcg4d import pcg4d_uniforms
    from fspt_tpu_torch.ops.traverse4 import packet_traverse4
    from fspt_tpu_torch.runtime.renderer import sample_step

    def eager(r):
        t0 = time.perf_counter()
        r.accum, r.count, r.rays = sample_step(
            r.arrays, r.cfg, r.scene.meta, r.camera, r.accum, r.count,
            r.rays, r.base_key, r.sample_idx, r.resolution, r.pixel_idx)
        r.sample_idx += 1
        r._sync()
        return time.perf_counter() - t0

    def replayed(r):
        t0 = time.perf_counter()
        r.step()
        return time.perf_counter() - t0

    def same(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("accum", "count", "rays"))

    cli = _config(types.SimpleNamespace(res="512", bounces=4, batch_spp=4,
                                        seed=0, no_compact=False))
    for case, cfg in (("bunny8", bench_config(512, 8)), ("bunny4", cli)):
        n = cfg.width * cfg.height
        want = integrator.traversal_launches(cfg, n, cfg.batch_spp)
        g, e = Renderer(scene, cfg, device="cuda"), Renderer(
            scene, cfg, device="cuda")
        first_s = replayed(g)                     # eager: the warm-up
        eager(e)
        capture_step_s = replayed(g)              # capture, then replay
        eager(e)
        capture_s = g._graph.capture_s
        if not same(g, e):
            raise AssertionError(f"graph {case}: the captured step differs "
                                 "from the eager one")
        ts = {"eager": [], "replay": []}
        launches = []
        uniforms = {"eager": set(), "replay": set()}
        for i in range(GRAPH_STEPS):
            # in turns: eager, replay, replay, eager, ...
            for kind in (("eager", "replay") if i % 2 == 0
                         else ("replay", "eager")):
                before = pcg4d_uniforms.launches
                if kind == "eager":
                    ts[kind].append(eager(e))
                else:
                    packet_traverse4.launches = 0
                    ts[kind].append(replayed(g))
                    launches.append(packet_traverse4.launches)
                uniforms[kind].add(pcg4d_uniforms.launches - before)
        if not same(g, e):
            raise AssertionError(f"graph {case}: replayed steps differ from "
                                 "eager sample_step calls")
        if set(launches) != {want}:
            raise AssertionError(f"graph {case}: traverse4 launches a "
                                 f"replayed step {launches}, not {want}")
        if len(uniforms["eager"]) != 1 or uniforms["replay"] != uniforms[
                "eager"]:
            raise AssertionError(f"graph {case}: pcg4d launches a step "
                                 f"{uniforms}, replayed against eager")
        stats = g.stats
        if (stats["graph_captures"], stats["graph_replays"]) != (
                1, GRAPH_STEPS + 1):
            raise AssertionError(f"graph {case}: {stats['graph_captures']} "
                                 f"captures, {stats['graph_replays']} "
                                 "replays")
        med = lambda xs: sorted(xs)[len(xs) // 2] * 1e3 / cfg.batch_spp
        eager_ms, replay_ms = med(ts["eager"]), med(ts["replay"])
        say("graph", case=case, size=f"{cfg.width}x{cfg.height}",
            spp=cfg.batch_spp, bounces=cfg.bounces, bit_equal=True,
            capture_s=f"{capture_s:.3f}",
            first_step_ms=f"{first_s * 1e3:.1f}",
            capture_step_ms=f"{capture_step_s * 1e3:.1f}",
            eager_ms_per_sample=f"{eager_ms:.3f}",
            replay_ms_per_sample=f"{replay_ms:.3f}",
            speedup=f"{eager_ms / replay_ms:.2f}",
            eager_steps_ms=",".join(f"{t * 1e3:.1f}" for t in ts["eager"]),
            replay_steps_ms=",".join(f"{t * 1e3:.1f}" for t in ts["replay"]),
            traverse4_launches_per_step=want,
            pcg4d_launches_per_step=min(uniforms["eager"]), card=repr(smi))
        del g, e
        torch.cuda.synchronize()


def main(kernels_only=False):
    if not os.path.isdir(os.path.join(HERE, "fspt_tpu_torch")):
        raise SystemExit("chip_smoke.py: fspt_tpu_torch/ is not beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    from fspt_tpu_torch.ops.traverse import capture_launches
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this smoke test needs an NVIDIA GPU")
    # host BVH builder's compiled cache stays inside the checkout
    os.environ.setdefault("FSPT_NATIVE_CACHE",
                          os.path.join(HERE, "fspt_tpu_torch", "_build"))
    os.makedirs(OUT_DIR, exist_ok=True)

    # ---- 1. device ------------------------------------------------------
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    say("device", name=repr(kind), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count(),
        max_sm_mhz=mhz)
    print(smi, flush=True)                        # name, power limit

    # ---- 2. build -------------------------------------------------------
    from fspt_tpu_torch.ops import _build
    from fspt_tpu_torch.ops.pcg4d import load_pcg4d, pcg4d_uniforms
    from fspt_tpu_torch.ops.traverse import load_walk1
    from fspt_tpu_torch.ops.traverse3 import load_walk
    from fspt_tpu_torch.ops.traverse4 import load_traverse4
    from fspt_tpu_torch.scripts.perf_r5_treelet import load_dense_mt
    from fspt_tpu_torch.scripts.perf_r5d import load_micro
    from fspt_tpu_torch.scripts.traverse5_proto import load_walk5
    sources = ("traverse4", "walk", "walk1", "walk5", "dense_mt", "micro",
               "pcg4d")
    t0 = time.perf_counter()
    _build.build_all(sources)
    for load in (load_traverse4, load_walk, load_walk1, load_walk5,
                 load_dense_mt, load_micro, load_pcg4d):
        load()
    wall = time.perf_counter() - t0
    for name in sources:
        info = _build.build_info[name]
        say("build", kernel=name, seconds=f"{wall:.2f}",
            nvcc_seconds=f"{info['seconds']:.2f}",
            lib=os.path.relpath(info["path"], HERE))
        for entry in ptxas_summary(info["log"]):
            print("  ptxas: " + " ".join(f"{k}={v}" for k, v in entry.items()),
                  flush=True)

    from fspt_tpu_torch import RenderConfig, Renderer, bench
    from fspt_tpu_torch.core import integrator, rng
    from fspt_tpu_torch.core.camera import generate_rays
    from fspt_tpu_torch.core.vec import V3
    from fspt_tpu_torch.ops import traverse3
    from fspt_tpu_torch.ops.traverse import (check_stack_overflow,
                                             packet_traverse,
                                             packet_traverse_reference,
                                             real_triangles,
                                             traversal_bound)
    from fspt_tpu_torch.ops.traverse3 import (packet_traverse3,
                                              packet_traverse3_reference,
                                              tally_growth)
    from fspt_tpu_torch.ops.traverse4 import (packet_traverse4,
                                              packet_traverse4_reference)
    from fspt_tpu_torch.testing import (icosphere_obj,
                                        make_bunny_standin_scene,
                                        make_test_scene)

    # ---- 3. scene -------------------------------------------------------
    t0 = time.perf_counter()
    scene = make_bunny_standin_scene(subdivisions=6)
    size = 512
    cfg = bench.bench_config(size, 8)
    r = Renderer(scene, cfg, device="cuda")
    a, meta = r.arrays, scene.meta
    children = (a.pk_nodes[:, 48:56] > -1e8).sum(1)
    edges = a.pk_leaves[:, :72].reshape(-1, 8, 9)[:, :, 3:].abs().sum(-1)
    say("scene", triangles=scene.num_triangles,
        node_rows=a.pk_nodes.shape[0], leaf_rows=a.pk_leaves.shape[0],
        table_mb=f"{(a.pk_nodes.numel() + a.pk_leaves.numel()) * 4 / 1e6:.1f}",
        stack_depth=max(cfg.stack_depth, meta.pk_stack_depth) + 16,
        children_per_node=f"{children.float().mean().item():.2f}",
        nodes_with_4_or_fewer=f"{(children <= 4).float().mean().item():.3f}",
        triangles_per_leaf=f"{(edges > 0).sum(1).float().mean().item():.2f}",
        seconds=f"{time.perf_counter() - t0:.2f}")

    # ---- 4. kernel vs plain, traverse4 ----------------------------------
    n = size * size
    k0 = rng.fold_in(rng.sample_key(r.base_key, 0), 0)
    cam = r.camera
    o, d = generate_rays(cam.position, cam.direction, cam.fov_scale,
                         cam.focal_depth, cam.aperture, r.resolution,
                         rng.stream_uniforms(k0, 0, (4, n), device=dev),
                         pixel_idx=r.pixel_idx)
    # the port's own launches of one sample: [primary, bounce 0, ..]
    with torch.no_grad():
        captured = capture_launches(
            integrator, "packet_traverse4",
            lambda: integrator.trace_paths(a, cfg, meta, o, d, k0))
    torch.cuda.synchronize()
    check_stack_overflow(dev)

    table_rows = a.pk_nodes.shape[0] + a.pk_leaves.shape[0]

    rows, bounds, unions = {}, {}, {}
    max_err = {"traverse4": 0.0, "walk3": 0.0, "walk1": 0.0}
    for label, (args, kw) in (("primary", captured[0]),
                              ("bounce0", captured[1])):
        counts = {}
        ms, plain_ms, err, hit = check_launch(
            f"traverse4 {label}", packet_traverse4,
            packet_traverse4_reference, args, kw, counts=counts)
        rows[("traverse4", label)] = (ms, plain_ms)
        max_err["traverse4"] = max(max_err["traverse4"], err)
        if label == "primary":
            primary8 = hit
        bound = launch_bound(counts, hit.t.numel(), kw.get("tree_width", 8),
                             kw["leaf_size"], table_rows)
        bounds[("traverse4", label)] = bound
        shape_traverse4(f"traverse4 {label}", hit, args[4], counts, bound, ms)

    # brute force over all triangles on a 4,096-ray subset: 2,048 primary
    # rays and 2,048 live (tmax > 0) rays of the bounce-0 launch
    def subset(args, idx):
        _, _, so, sd, stm = args
        if stm is None:
            stm = torch.full_like(so.x, 1e5)
        return (torch.stack(list(so), -1)[idx], torch.stack(list(sd), -1)[idx],
                stm[idx])

    live = torch.nonzero(captured[1][0][4] > 0).flatten()
    parts = [subset(captured[0][0], torch.arange(0, n, n // 2048,
                                                 device=dev)),
             subset(captured[1][0], live[torch.linspace(
                 0, live.numel() - 1, 2048, device=dev).long()])]
    bo, bd, bt = (torch.cat([p[i] for p in parts]) for i in range(3))
    kh = packet_traverse4(a.pk_nodes, a.pk_leaves, V3(*bo.T.contiguous()),
                          V3(*bd.T.contiguous()), bt.contiguous(),
                          **captured[1][1])
    brt, brs = brute_force(a, bo, bd, bt)
    same = kh.slot.long() == brs
    tie = torch.isclose(kh.t, brt, rtol=1e-6, atol=0.0)
    agree = float(same.float().mean())
    if agree < 0.999 or not bool((same | tie).all()):
        raise AssertionError(f"brute force: slot agreement {agree:.5f}, "
                             f"{int((~(same | tie)).sum())} non-tie misses")
    say("brute", rays=4096, triangles=scene.num_triangles,
        slot_agreement=f"{agree:.5f}", ties=int((~same).sum()))

    # ---- 5. width 16 -----------------------------------------------------
    t0 = time.perf_counter()
    scene16 = make_bunny_standin_scene(subdivisions=6, bvh_width=16)
    a16, meta16 = scene16.to_torch(dev), scene16.meta
    depth16 = max(cfg.stack_depth, meta16.pk_stack_depth)
    say("width16", node_rows=a16.pk_nodes.shape[0],
        leaf_rows=a16.pk_leaves.shape[0], pk_stack_depth=depth16,
        seconds=f"{time.perf_counter() - t0:.2f}")
    args16 = (a16.pk_nodes, a16.pk_leaves, o, d, None)
    kw16 = dict(leaf_size=meta16.leaf_size, tree_width=16)
    check_launch("traverse4 width16 primary", packet_traverse4,
                 packet_traverse4_reference, args16,
                 dict(kw16, stack_depth=depth16 + 32), base_hit=primary8)
    check_launch("walk3 width16 primary", packet_traverse3,
                 packet_traverse3_reference, args16,
                 dict(kw16, stack_depth=depth16), base_hit=primary8)
    del a16

    # ---- 6. kernel vs plain, the group walks -----------------------------
    walk_cfg = RenderConfig(width=size, height=size, bounces=8,
                            extra_refraction_iters=0, batch_spp=8,
                            intersector="walk")
    with torch.no_grad():
        walk_calls = capture_launches(
            integrator, "packet_traverse3",
            lambda: integrator.trace_paths(a, walk_cfg, meta, o, d, k0))
    torch.cuda.synchronize()
    check_stack_overflow(dev)
    for label, (args, kw) in (("primary", walk_calls[0]),
                              ("bounce0", walk_calls[1])):
        counts = {}
        ms, plain_ms, err, hit = check_launch(
            f"walk3 {label}", packet_traverse3, packet_traverse3_reference,
            args, kw, lanes=label == "primary", counts=counts)
        rows[("walk3", label)] = (ms, plain_ms)
        max_err["walk3"] = max(max_err["walk3"], err)
        tally = tally_growth(lambda: packet_traverse3(*args, **kw))
        bounds[("walk3", label)], unions[label] = walk3_bounds(
            hit, counts, tally, kw, table_rows, group=traverse3.GROUP)
        shape_walk3(f"walk3 {label}", hit, counts, tally,
                    bounds[("walk3", label)], unions[label], ms)
    (ms, plain_ms, err, bounds[("walk3", "dungeon")],
     unions["dungeon"]) = dungeon_walk3()
    rows[("walk3", "dungeon")] = (ms, plain_ms)
    max_err["walk3"] = max(max_err["walk3"], err)
    # walk1: the primary rays and the bounce-0 launch of a "packet" step
    pcfg = RenderConfig(width=size, height=size, bounces=8,
                        extra_refraction_iters=0, batch_spp=1,
                        intersector="packet")
    with torch.no_grad():
        pkt_calls = capture_launches(
            integrator, "packet_traverse",
            lambda: integrator.trace_paths(a, pcfg, meta, o, d, k0))
    torch.cuda.synchronize()
    check_stack_overflow(dev)
    pkt_kw = dict(leaf_size=meta.leaf_size,
                  stack_depth=max(cfg.stack_depth, meta.pk_stack_depth))
    for label, (args, kw) in (
            ("primary", ((a.pk_nodes, a.pk_leaves, o, d, None), pkt_kw)),
            ("bounce0", pkt_calls[1])):
        counts = {}
        ms, plain_ms, err, hit = check_launch(
            f"walk1 {label}", packet_traverse, packet_traverse_reference,
            args, kw, counts=counts)
        rows[("walk1", label)] = (ms, plain_ms)
        max_err["walk1"] = max(max_err["walk1"], err)
        bound = launch_bound(counts, hit.t.numel(), 8, kw["leaf_size"],
                             table_rows, group=1024)
        bounds[("walk1", label)] = bound
        shape_walk1(f"walk1 {label}", hit, counts, bound, ms, mhz)

    # ---- 6b. pcg4d ---------------------------------------------------------
    pcg4d_times = phase_pcg4d(smi)
    if kernels_only:
        return

    # ---- 7. goldens on the card ------------------------------------------
    def golden(name, cfg_kw, steps):
        ref = np.load(os.path.join(HERE, "tests", "goldens", f"{name}.npy"))
        gcfg = RenderConfig(**{**dict(width=32, height=32, bounces=3,
                                      extra_refraction_iters=2, batch_spp=4,
                                      seed=7), **cfg_kw})
        img = Renderer(make_test_scene(subdivisions=3), gcfg,
                       device="cuda").step(steps).hdr_image()
        rel = float((np.abs(img - ref) / np.maximum(np.abs(ref), 1e-2)).max())
        if not rel < 0.05:
            raise AssertionError(f"golden {name} ({gcfg.intersector}): max "
                                 f"rel err {rel}")
        say("golden", case=name, intersector=gcfg.intersector, mode=gcfg.mode,
            max_rel_err=f"{rel:.3g}", bound=0.05)

    golden("bunny_class", dict(intersector="split"), 2)
    golden("bunny_class", {}, 2)
    golden("heatmap", dict(mode="bvh_heatmap", batch_spp=1), 1)

    # ---- 8. bench ("split") ---------------------------------------------
    r.step()                                      # warm-up
    pcg4d_before = pcg4d_uniforms.launches
    steps = bench.time_steps(r, BENCH_STEPS)
    pcg4d_per_step = (pcg4d_uniforms.launches - pcg4d_before) / len(steps)
    line = bench.summarize(r, steps, smi)         # raises on a wrong count
    launches = sum(s["launches"] for s in steps)
    samples = sum(s["samples"] for s in steps)
    seconds = sum(s["seconds"] for s in steps)
    rays = sum(s["rays"] for s in steps)
    say("bench", size=f"{size}x{size}", spp=samples, bounces=8,
        steps=len(steps), seconds=f"{seconds:.4f}",
        ms_per_sample_median=f"{line['ms_per_sample_median']:.3f}",
        ms_per_sample_min=f"{line['ms_per_sample_min']:.3f}",
        ms_per_sample_max=f"{line['ms_per_sample_max']:.3f}",
        honest_rays=f"{rays:.0f}", rays_per_s=f"{line['value']:.0f}",
        kernel_launches=launches,
        expected_launches=len(steps) * line["traverse4_launches_per_step"],
        pcg4d_launches_per_step=pcg4d_per_step, card=repr(smi))
    print("[bench_json] " + json.dumps(line), flush=True)
    hdr = check_image(r, "bench", size)
    png = os.path.join(OUT_DIR, "chip_smoke_bench.png")
    r.save(png)
    m = r.step_metrics()
    fmt = lambda xs: ",".join(f"{x:.4f}" for x in xs)
    say("metrics", scatter_occupancy=fmt(m["scatter_occupancy"]),
        shadow_occupancy=fmt(m["shadow_occupancy"]),
        visits_per_lane=fmt(m["visits_per_lane"]),
        rr_lanes=f"{m['rr_lanes']:.0f}", image_mean=f"{hdr.mean():.5f}",
        png=os.path.relpath(png, HERE))
    split_launches = launches
    del r

    # ---- 9. walk bench (the CLI's --no-compact configuration) -----------
    rw = Renderer(scene, walk_cfg, device="cuda")
    rw.step()                                     # warm-up
    launches, samples, seconds, rays = timed_steps(rw, 2, packet_traverse3)
    expected = 2 * integrator.traversal_launches(walk_cfg, n,
                                                 walk_cfg.batch_spp)
    if launches != expected:
        raise AssertionError(f"walk3 launched {launches} times on the walk "
                             f"path, expected {expected}")
    hdr = check_image(rw, "walk bench", size)
    png = os.path.join(OUT_DIR, "chip_smoke_walk.png")
    rw.save(png)
    say("walk_bench", size=f"{size}x{size}", spp=samples, bounces=8,
        seconds=f"{seconds:.4f}",
        ms_per_sample=f"{seconds / samples * 1e3:.3f}",
        honest_rays=f"{rays:.0f}", rays_per_s=f"{rays / seconds:.0f}",
        kernel_launches=launches, expected_launches=expected,
        image_mean=f"{hdr.mean():.5f}", png=os.path.relpath(png, HERE),
        card=repr(smi))
    walk_launches = launches
    del rw

    # ---- 10. packet ------------------------------------------------------
    rp = Renderer(scene, pcfg, device="cuda")
    launches, samples, seconds, rays = timed_steps(rp, 1, packet_traverse)
    expected = integrator.traversal_launches(pcfg, n, 1)
    if launches != expected:
        raise AssertionError(f"walk1 launched {launches} times on the "
                             f"packet path, expected {expected}")
    hdr = check_image(rp, "packet", size)
    say("packet", size=f"{size}x{size}", spp=samples,
        seconds=f"{seconds:.4f}", honest_rays=f"{rays:.0f}",
        kernel_launches=launches, expected_launches=expected,
        image_mean=f"{hdr.mean():.5f}")
    packet_launches = launches
    del rp

    # ---- 11. heatmap -----------------------------------------------------
    hcfg = RenderConfig(width=size, height=size, mode="bvh_heatmap")
    rh = Renderer(scene, hcfg, device="cuda")
    launches, samples, seconds, _ = timed_steps(rh, 1, packet_traverse3)
    if launches != integrator.traversal_launches(hcfg, n, 1):
        raise AssertionError(f"heatmap: walk3 launched {launches} times")
    hdr = check_image(rh, "heatmap", size)
    lane_mean = float(hdr[..., 0].mean() / hcfg.heatmap_scale)
    png = os.path.join(OUT_DIR, "chip_smoke_heatmap.png")
    rh.save(png)
    say("heatmap", size=f"{size}x{size}", seconds=f"{seconds:.4f}",
        mean_lane_count=f"{lane_mean:.3f}",
        max_lane_count=f"{hdr[..., 0].max() / hcfg.heatmap_scale:.0f}",
        png=os.path.relpath(png, HERE))
    del rh

    # ---- 12. CLI ---------------------------------------------------------
    cli_dir = os.path.join(OUT_DIR, "cli")
    os.makedirs(cli_dir, exist_ok=True)
    with open(os.path.join(cli_dir, "mesh.obj"), "w") as f:
        f.write(icosphere_obj(2))
    scene_path = os.path.join(cli_dir, "scene.json")
    with open(scene_path, "w") as f:
        json.dump({"environment": [[0.2, 0.2, 0.3], [0.9, 0.9, 0.8]],
                   "props": [{"path": "mesh.obj",
                              "diffuse": [0.8, 0.3, 0.2]}]}, f)
    for flags in (["--no-compact"], []):
        out = os.path.join(cli_dir, f"cli{'_'.join(flags) or '_compact'}.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fspt_tpu_torch", "render", scene_path,
             "--res", "64", "--samples", "4", *flags, "-o", out],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0 or not os.path.exists(out):
            raise AssertionError(f"CLI render {flags} failed "
                                 f"({proc.returncode}):\n{proc.stderr}")
        say("cli", flags=" ".join(flags) or "(default)", rc=proc.returncode,
            seconds=f"{time.perf_counter() - t0:.2f}",
            png=os.path.relpath(out, HERE))

    # ---- 13. v5 on the captured bounce-0 launch --------------------------
    from fspt_tpu_torch.scripts import (perf_r5_treelet, perf_r5d, perf_r5i,
                                        r5common)
    from fspt_tpu_torch.scripts.traverse5_proto import (
        packet_traverse5, packet_traverse5_reference)
    t0 = time.perf_counter()
    so, sd, stm, sa = r5common.capture_bounce0(scene, a, meta,
                                               perf_r5i.bench_config())
    sdep = meta.pk_stack_depth + 16
    say("capture", lanes=so.x.shape[0], active=int(sa.sum()),
        seconds=f"{time.perf_counter() - t0:.2f}")
    launch = (a.pk_nodes, a.pk_leaves, so, sd, stm)
    v5_kw = dict(leaf_size=meta.leaf_size, stack_depth=sdep)
    counts = {}
    ms, plain_ms, err, hit5 = check_launch(
        "walk5 bounce0", packet_traverse5, packet_traverse5_reference,
        launch, v5_kw, counts=counts)
    rows[("walk5", "bounce0")] = (ms, plain_ms)
    max_err["walk5"] = err
    if counts["node"] + counts["leaf"] != int(hit5.visits[::128].sum()) * 128:
        raise AssertionError("walk5: node + leaf visits differ from the "
                             "kernel's visits")
    bounds[("walk5", "bounce0")] = launch_bound(
        counts, so.x.shape[0], 8, meta.leaf_size, table_rows, group=128)
    shape_walk5("walk5 bounce0", hit5, counts, bounds[("walk5", "bounce0")],
                ms)
    hit4 = packet_traverse4(*launch, **v5_kw)
    same = hit5.slot == hit4.slot
    tie = torch.isclose(hit5.t, hit4.t, rtol=1e-5, atol=1e-6)
    slot_match = float(same.float().mean())
    if slot_match < 0.9999 or not bool((same | tie).all()):
        raise AssertionError(f"walk5 against traverse4: slot_match "
                             f"{slot_match:.6f}, "
                             f"{int((~(same | tie)).sum())} non-tie misses")
    say("walk5_vs_traverse4", lanes=so.x.shape[0],
        slot_match=f"{slot_match:.6f}", ties=int((~same).sum()),
        mean_visits_per_walk=f"{hit5.visits.float().mean().item():.2f}")
    packet_traverse5.launches = 0
    r5i = perf_r5i.main(scene)
    v5_launches = packet_traverse5.launches
    if len(r5i["sets"]) != len(perf_r5i.SWEEP) or v5_launches == 0:
        raise AssertionError(f"perf_r5i ran {len(r5i['sets'])} sets with "
                             f"{v5_launches} walk5 launches")
    say("perf_r5i", sets=len(r5i["sets"]), walk5_launches=v5_launches,
        v4_ms=f"{r5i['t4'] * 1e3:.3f}",
        best_v5_ms=f"{r5i['best'][0] * 1e3:.3f}",
        verdict="GO" if r5i["go"] else "NO-GO", card=repr(smi))

    # ---- 14. dense MT -----------------------------------------------------
    dense_mt, launch_dense_mt = (perf_r5_treelet.dense_mt,
                                 perf_r5_treelet.launch_dense_mt)
    leaves = a.pk_leaves
    n_real = 64
    planes = torch.stack([*so, *sd, stm])[:, :n_real * 1024]
    real_rays = planes.reshape(7, n_real, 8, 128).permute(1, 0, 2, 3)
    real_rays = real_rays.contiguous()
    for T in perf_r5_treelet.TREELETS:
        n_tl = leaves.shape[0] // (T // 8)
        # real tiles: each tile's treelet holds the traverse4 hit of its
        # first hitting lane (so that rays hit), else a random one
        first = hit4.slot[:n_real * 1024].reshape(n_real, 1024)
        has = (first >= 0).any(1)
        lane = torch.argmax((first >= 0).to(torch.int32), 1)
        tl_hit = torch.clamp(first[torch.arange(n_real, device=dev), lane]
                             // T, max=n_tl - 1)
        rnd = torch.randint(0, n_tl, (n_real,), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(T))
        real_tl = torch.where(has, tl_hit, rnd).to(torch.int32)[:, None]
        for label, (tl, rays) in (
                ("stand-in", perf_r5_treelet.stand_in_tiles(1024, n_tl,
                                                            dev)),
                ("captured", (real_tl.contiguous(), real_rays))):
            tk, sk = dense_mt(tl, leaves, rays, T)
            tp, sp = perf_r5_treelet.dense_mt_reference(tl, leaves, rays, T)
            torch.cuda.synchronize()
            if not (torch.equal(tk, tp) and torch.equal(sk, sp)):
                raise AssertionError(f"dense_mt T={T} {label}: kernel and "
                                     "plain version differ")
            max_err["dense_mt"] = max(max_err.get("dense_mt", 0.0),
                                      float((tk - tp).abs().max()))
            say("dense_mt", T=T, tiles=tl.shape[0], rays=label,
                hits=int((sk >= 0).sum()), bit_equal="t,slot")
    dense_mt.launches = 0
    tre = perf_r5_treelet.main(scene)
    dense_launches = dense_mt.launches
    if dense_launches == 0:
        raise AssertionError("perf_r5_treelet launched dense_mt no time")
    n_tiles = tre[64]["n_tiles"]
    tl, rays = perf_r5_treelet.stand_in_tiles(n_tiles,
                                              leaves.shape[0] // 8, dev)
    # (a launch of stage E is shorter than its wrapper's host time: queued)
    ms = cuda_ms(lambda: launch_dense_mt(tl, leaves, rays, 64), 10,
                 queued=True)
    wrapper_ms = cuda_ms(lambda: launch_dense_mt(tl, leaves, rays, 64), 10)
    plain_ms = cuda_ms(lambda: perf_r5_treelet.dense_mt_reference(
        tl, leaves, rays, 64), 1)
    rows[("dense_mt", "stage_e")] = (ms, plain_ms)
    # a tile's 1,024 lanes each test the real triangles of the treelet's 64
    # slots (8 leaf rows)
    tile_rows = leaves[tl.long() * 8 + torch.arange(8, device=dev)]
    tile_tris = int(real_triangles(tile_rows, 8).sum())
    tile_slots = int(perf_r5_treelet.tested_slots(tile_rows).sum())
    bounds[("dense_mt", "stage_e")] = traversal_bound(
        n_tiles * 1024, 8, 8, leaves.shape[0], 0, n_tiles * 1024 * 8,
        tri_tests=tile_tris * 1024, group=1024, out_planes=2)
    say("treelet", dense_launches=dense_launches, T=64, tiles=n_tiles,
        triangles_per_tile=f"{tile_tris / n_tiles:.2f}",
        slots_tested_per_tile=f"{tile_slots / n_tiles:.2f}",
        **bound_fields(bounds[("dense_mt", "stage_e")]),
        ms=f"{ms:.4f}", wrapper_ms=f"{wrapper_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        verdicts=",".join("GO" if tre[T]["go"] else "NO-GO"
                          for T in perf_r5_treelet.TREELETS),
        card=repr(smi))

    # ---- 15. micro ----------------------------------------------------------
    table, mrays = perf_r5d.make_inputs(dev, scene)

    def micro_check(v, k, counts=None):
        """Kernel against plain version, bit for bit (NaN lanes as NaN);
        returns the plain version's ms (one run)."""
        ko = perf_r5d.micro(table, mrays, v, k)
        held = []
        plain_ms = cuda_ms(lambda: held.append(perf_r5d.micro_reference(
            table, mrays, v, k, counts=counts)), 1, warmup=False)
        po = held[0]
        same = (ko == po) | (ko.isnan() & po.isnan())
        if not bool(same.all()):
            raise AssertionError(f"micro {v} k={k}: kernel and plain version "
                                 f"differ on {int((~same).sum())} lanes")
        max_err["micro"] = max(max_err.get("micro", 0.0), float(
            torch.where(same, 0.0, (ko - po).abs()).max()))
        say("micro", variant=v, k=k, bit_equal="out",
            hits=int((ko < 1e9).sum()), plain_ms=f"{plain_ms:.2f}")
        return plain_ms

    for v in perf_r5d.VARIANTS:
        micro_check(v, 64)
    for v in ("leaf", "leaf2"):
        micro_check(v, 512)
    lanes = perf_r5d.WALKS * perf_r5d.LANES
    # leaf4's rows in closed form (substep i draws hash((1 + i) % rows, i)
    # + 0..3), held to what the plain version tallies over the K substeps
    i = torch.arange(perf_r5d.K, device=dev)
    drawn = torch.remainder(perf_r5d._row_hash(
        torch.remainder(1 + i, table.shape[0]), i, table.shape[0])[:, None]
        + torch.arange(4, device=dev), table.shape[0])
    tris4 = real_triangles(table[drawn], 8).sum(1) * lanes
    counts = {}
    leaf4_plain_ms = micro_check("leaf4", perf_r5d.K, counts)
    if int(counts["triangles"]) != int(tris4.sum()):
        raise AssertionError("micro leaf4: the closed form of its rows "
                             "differs from what the plain version drew")
    # the K=4096 comparison of `full` also gives the plain version's time
    # and the real triangles the substeps tested, for the bound
    counts = {}
    full_plain_ms = micro_check("full", perf_r5d.K, counts)
    # `full`: every substep is a node visit (all 8 children: the micro has no
    # link test) and a leaf visit (the real triangles of the row it drew) of
    # all 1,024 lanes, one row fetch per 128-lane walk; `leaf4`: four leaf
    # visits a substep and no node visit
    for v, node_visits, units, tris, plain_ms in (
            ("full", lanes * perf_r5d.K, 1, int(counts["triangles"]),
             full_plain_ms),
            ("leaf4", 0, 4, int(tris4.sum()), leaf4_plain_ms)):
        ms = cuda_ms(lambda: perf_r5d.micro(table, mrays, v), 5)
        rows[("micro", v)] = (ms, plain_ms)
        bounds[("micro", v)] = traversal_bound(
            lanes, 8, 8, table.shape[0], node_visits,
            lanes * perf_r5d.K * units, tri_tests=tris,
            group=perf_r5d.LANES, in_planes=6, out_planes=1)
        say("micro_bound", variant=v, k=perf_r5d.K,
            triangles_per_substep=f"{tris / lanes / perf_r5d.K:.2f}",
            **bound_fields(bounds[("micro", v)]), ms=f"{ms:.4f}",
            share_of_bound=f"{bounds[('micro', v)]['bound_ms'] / ms:.4f}",
            cycles_per_substep=f"{ms * 1e-3 * mhz * 1e6 / perf_r5d.K:.0f}")
    perf_r5d.micro.launches = 0
    ns = perf_r5d.main(scene)
    micro_launches = perf_r5d.micro.launches
    if micro_launches == 0:
        raise AssertionError("perf_r5d launched micro no time")
    say("perf_r5d", micro_launches=micro_launches, k=perf_r5d.K,
        **{f"{v}_ns": f"{x:.1f}" for v, x in ns.items()}, card=repr(smi))

    # ---- 16. train ----------------------------------------------------------
    phase_train(scene, smi)
    check_stack_overflow(dev)

    # ---- 17. refit and animate ----------------------------------------------
    animate_launches = phase_refit(cfg, smi)

    # ---- 18. view -----------------------------------------------------------
    view_launches = phase_view(scene, cfg, smi)

    # ---- 19. profile --------------------------------------------------------
    phase_profile(scene, cfg, smi)
    check_stack_overflow(dev)

    # ---- 20. dist -----------------------------------------------------------
    dist_launches, dist_walk_launches = phase_dist(scene, smi)
    check_stack_overflow(dev)

    # ---- 21. perf_phase -----------------------------------------------------
    phase_launches = phase_perf(scene, smi)
    check_stack_overflow(dev)

    # ---- 22. graph ----------------------------------------------------------
    phase_graph(scene, smi)
    check_stack_overflow(dev)

    # ---- the kernels and the result --------------------------------------
    # library_ms is null in every row: no PyTorch call computes a BVH
    # traversal.  bound_ms: ops/traverse.py `traversal_bound` on this run's
    # visit counts and tested children and triangles, against the published 3.35 TB/s and 67 TFLOP/s float32
    # (the kernels are built with --fmad=false, so half of that float32
    # rate is the most they can reach).
    def row(name, source, replaces, launches, per_step):
        launch = "bounce0" if (name, "bounce0") in rows else "primary"
        ms, plain = rows[(name, launch)]
        pms, pplain = rows[(name, "primary")]
        b, pb = bounds[(name, launch)], bounds[(name, "primary")]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_per_step": per_step,
                "max_abs_err": max_err[name], "launch": launch, "ms": ms,
                "plain_ms": plain, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": None,
                "primary_ms": pms, "primary_plain_ms": pplain,
                "primary_bound_ms": pb["bound_ms"],
                "primary_bound_by": pb["bound_by"]}

    def study_row(name, launch, source, replaces, launches):
        ms, plain = rows[(name, launch)]
        b = bounds[(name, launch)]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_per_step": launches,
                "max_abs_err": max_err.get(name, 0.0), "launch": launch,
                "ms": ms, "plain_ms": plain, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": None}

    per_step = lambda c: integrator.traversal_launches(c, n, c.batch_spp)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {**row("traverse4", "fspt_tpu_torch/csrc/traverse4.cu",
               "fspt_tpu/ops/traverse4.py:60", split_launches,
               per_step(cfg)),
         "animate_launches_per_frame": animate_launches,
         "view_launches": view_launches,
         "dist_launches_per_step": dist_launches,
         "perf_phase_launches": phase_launches["traverse4"]},
        {**row("walk3", "fspt_tpu_torch/csrc/walk.cu",
               "fspt_tpu/ops/traverse3.py:64", walk_launches,
               per_step(walk_cfg)),
         "dungeon_bounce0_ms": rows[("walk3", "dungeon")][0],
         "dungeon_bounce0_plain_ms": rows[("walk3", "dungeon")][1],
         "dungeon_bounce0_bound_ms": bounds[("walk3", "dungeon")]["bound_ms"],
         "dungeon_bounce0_bound_by": bounds[("walk3", "dungeon")]["bound_by"],
         "union_bound_ms": unions["bounce0"]["bound_ms"],
         "primary_union_bound_ms": unions["primary"]["bound_ms"],
         "dungeon_bounce0_union_bound_ms": unions["dungeon"]["bound_ms"],
         "dist_launches_per_step": dist_walk_launches,
         "perf_phase_launches": phase_launches["walk3"]},
        row("walk1", "fspt_tpu_torch/csrc/walk1.cu",
            "fspt_tpu/ops/traverse.py:243", packet_launches, per_step(pcfg)),
        study_row("walk5", "bounce0", "fspt_tpu_torch/csrc/walk5.cu",
                  "scripts/traverse5_proto.py:70", v5_launches),
        study_row("dense_mt", "stage_e", "fspt_tpu_torch/csrc/dense_mt.cu",
                  "scripts/perf_r5_treelet.py:94", dense_launches),
        {**study_row("micro", "full", "fspt_tpu_torch/csrc/micro.cu",
                     "scripts/perf_r5d.py:42", micro_launches),
         "leaf4_ms": rows[("micro", "leaf4")][0],
         "leaf4_plain_ms": rows[("micro", "leaf4")][1],
         "leaf4_bound_ms": bounds[("micro", "leaf4")]["bound_ms"],
         "leaf4_bound_by": bounds[("micro", "leaf4")]["bound_by"]},
        # no Pallas kernel: fspt_tpu/core/rng.py's PCG4D is jnp code
        {"name": "pcg4d", "route": "cuda",
         "source": "fspt_tpu_torch/csrc/pcg4d.cu", "replaces": None,
         "launches_per_step": pcg4d_per_step, "launch": "bounce0",
         "ms": pcg4d_times["bounce0"][0],
         "plain_ms": pcg4d_times["bounce0"][1],
         "bound_ms": pcg4d_times["bounce0"][2], "bound_by": "bytes",
         "library_ms": None,
         **{f"{k}_{f}": pcg4d_times[k][i] for k in ("merged", "raygen")
            for i, f in enumerate(("ms", "plain_ms", "bound_ms"))},
         "plain_graph_ms": pcg4d_times["bounce0"][3]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(*sys.argv[2:])
    else:
        main(kernels_only=sys.argv[1:] == ["--kernels-only"])
