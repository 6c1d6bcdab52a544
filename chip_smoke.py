#!/usr/bin/env python3
"""Smoke test of the fspt_tpu_torch port on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. device: name, `nvidia-smi` name and power limit, torch/CUDA versions;
  2. build: nvcc builds csrc/traverse4.cu into fspt_tpu_torch/_build/;
  3. scene: the bench scene (82k-triangle bunny stand-in) onto the card;
  4. kernel vs plain: the traverse4 CUDA kernel against its plain PyTorch
     version on one sample's 262,144 primary rays and on the port's own
     bounce-0 scatter+shadow launch — bit-equal slot/visits/t/u/v, any-hit
     flags and per-ray tmax clipping — plus 4,096 rays against brute-force
     Moller-Trumbore over every triangle; times of both versions;
  5. golden: a 32x32 render on the card against tests/goldens/bunny_class.npy
     (tests/test_goldens.py's 5% bound);
  6. bench: the bench configuration at 512x512, 8 bounces, 8 spp per step —
     one warm-up step, then 4 timed steps with the kernel's launch count
     reset before and read after; rays/s, ms/sample, per-bounce occupancy;
     the image must be finite and non-zero and is written as a PNG.
Then one JSON line with the kernels' numbers, and last the result line.

It imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
BENCH_SCHEDULE = (1.5, 11, 48, 160, 640, 2048, 2048, 2048)


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs, after one warm-up."""
    import torch
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


def main():
    if not os.path.isdir(os.path.join(HERE, "fspt_tpu_torch")):
        raise SystemExit("chip_smoke.py: fspt_tpu_torch/ is not beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
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
    say("device", name=repr(kind), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    print(smi, flush=True)                        # name, power limit

    # ---- 2. build -------------------------------------------------------
    from fspt_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_traverse4()
    info = _build.build_info["traverse4"]
    say("build", kernel="traverse4", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{info['seconds']:.2f}",
        lib=os.path.relpath(info["path"], HERE))
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    from fspt_tpu_torch import RenderConfig, Renderer
    from fspt_tpu_torch.core import integrator, rng
    from fspt_tpu_torch.core.camera import generate_rays
    from fspt_tpu_torch.core.vec import V3
    from fspt_tpu_torch.ops.traverse4 import (check_stack_overflow,
                                              packet_traverse4,
                                              packet_traverse4_reference)
    from fspt_tpu_torch.testing import (make_bunny_standin_scene,
                                        make_test_scene)

    # ---- 3. scene -------------------------------------------------------
    t0 = time.perf_counter()
    scene = make_bunny_standin_scene(subdivisions=6)
    size = 512
    cfg = RenderConfig(width=size, height=size, bounces=8,
                       extra_refraction_iters=0, batch_spp=8, compact=True,
                       wavefront_batch=True, sort_state=True,
                       intersector="split", nee_env_nearest=True,
                       escape_env_nearest=True,
                       compact_schedule=BENCH_SCHEDULE)
    r = Renderer(scene, cfg, device="cuda")
    a, meta = r.arrays, scene.meta
    say("scene", triangles=scene.num_triangles,
        node_rows=a.pk_nodes.shape[0], leaf_rows=a.pk_leaves.shape[0],
        table_mb=f"{(a.pk_nodes.numel() + a.pk_leaves.numel()) * 4 / 1e6:.1f}",
        stack_depth=max(cfg.stack_depth, meta.pk_stack_depth) + 16,
        seconds=f"{time.perf_counter() - t0:.2f}")

    # ---- 4. kernel vs plain ---------------------------------------------
    n = size * size
    k0 = rng.fold_in(rng.sample_key(r.base_key, 0), 0)
    cam = r.camera
    o, d = generate_rays(cam.position, cam.direction, cam.fov_scale,
                         cam.focal_depth, cam.aperture, r.resolution,
                         rng.stream_uniforms(k0, 0, (4, n), device=dev),
                         pixel_idx=r.pixel_idx)
    # capture the port's own launches of one sample: [primary, bounce 0, ..]
    captured = []

    def capture(*args, **kw):
        captured.append((args, kw))
        return packet_traverse4(*args, **kw)

    integrator.packet_traverse4 = capture
    with torch.no_grad():
        integrator.trace_paths(a, cfg, meta, o, d, k0)
    integrator.packet_traverse4 = packet_traverse4
    torch.cuda.synchronize()
    check_stack_overflow(dev)

    kernel_rows = {}
    max_err = 0.0
    for label, (args, kw) in (("primary", captured[0]),
                              ("bounce0", captured[1])):
        nodes, leaves, ro, rd, tmax = args
        lanes = ro.x.shape[0]
        run_k = lambda **x: packet_traverse4(nodes, leaves, ro, rd, tmax,
                                             **{**kw, **x})
        run_p = lambda **x: packet_traverse4_reference(nodes, leaves, ro, rd,
                                                       tmax, **{**kw, **x})
        hit, ref = run_k(), run_p()
        torch.cuda.synchronize()
        max_err = max(max_err, compare(f"{label} nearest", hit, ref))
        anyk, anyp = run_k(any_hit=True), run_p(any_hit=True)
        compare(f"{label} any-hit", anyk, anyp)
        if not torch.equal(anyk.slot >= 0, hit.slot >= 0):
            raise AssertionError(f"{label}: any-hit occlusion flags differ "
                                 "from the nearest hit's")
        # per-ray tmax clipping: each hit ray's tmax set to 0.2-0.7x or
        # 1.6-2.1x its nearest t (it must then miss, or keep its hit)
        gen = torch.Generator(device=dev).manual_seed(0)
        u = torch.rand(lanes, device=dev, generator=gen)
        frac = torch.where(u < 0.5, 0.2 + u, 1.1 + u)
        base_t = tmax if tmax is not None else torch.full_like(hit.t, 1e5)
        clip = torch.where(hit.slot >= 0, hit.t * frac, base_t)
        ck = packet_traverse4(nodes, leaves, ro, rd, clip, **kw)
        cp = packet_traverse4_reference(nodes, leaves, ro, rd, clip, **kw)
        compare(f"{label} clipped", ck, cp)
        kept = (hit.slot >= 0) & (frac > 1.0)
        if not (torch.equal(ck.slot[kept], hit.slot[kept])
                and bool((ck.slot[frac <= 1.0] < 0).all())):
            raise AssertionError(f"{label}: tmax clipping is inconsistent")
        check_stack_overflow(dev)
        ms = cuda_ms(run_k, 10)
        plain_ms = cuda_ms(run_p, 2)
        kernel_rows[label] = (ms, plain_ms, lanes)
        say("kernel", launch=label, lanes=lanes,
            hits=int((hit.slot >= 0).sum()),
            mean_visits=f"{hit.visits.float().mean().item():.2f}",
            bit_equal="slot,visits,t,u,v", any_hit="equal", clip="equal",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")

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

    # ---- 5. golden on the card -------------------------------------------
    golden = np.load(os.path.join(HERE, "tests", "goldens",
                                  "bunny_class.npy"))
    gcfg = RenderConfig(width=32, height=32, bounces=3,
                        extra_refraction_iters=2, batch_spp=4, seed=7,
                        intersector="split")
    gimg = Renderer(make_test_scene(subdivisions=3), gcfg,
                    device="cuda").step(2).hdr_image()
    grel = float((np.abs(gimg - golden)
                  / np.maximum(np.abs(golden), 1e-2)).max())
    if not grel < 0.05:
        raise AssertionError(f"golden bunny_class: max rel err {grel}")
    say("golden", case="bunny_class", max_rel_err=f"{grel:.3g}", bound=0.05)

    # ---- 6. bench --------------------------------------------------------
    r.step()                                      # warm-up
    s0 = r.stats
    packet_traverse4.launches = 0
    r.step(4)
    launches = packet_traverse4.launches
    s1 = r.stats
    expected = 4 * integrator.traversal_launches(cfg, n, cfg.batch_spp)
    if launches != expected:
        raise AssertionError(f"traverse4 launched {launches} times on the "
                             f"main path, expected {expected}")
    samples, seconds, rays = (s1[k] - s0[k]
                              for k in ("samples", "seconds", "rays"))
    say("bench", size=f"{size}x{size}", spp=samples, bounces=8,
        seconds=f"{seconds:.4f}",
        ms_per_sample=f"{seconds / samples * 1e3:.3f}",
        honest_rays=f"{rays:.0f}", rays_per_s=f"{rays / seconds:.0f}",
        kernel_launches=launches, expected_launches=expected,
        card=repr(smi))
    hdr = r.hdr_image()
    if hdr.shape != (size, size, 3) or not np.isfinite(hdr).all():
        raise AssertionError("bench image is not a finite 512x512x3 array")
    if not hdr.mean() > 0:
        raise AssertionError("bench image is black")
    png = os.path.join(OUT_DIR, "chip_smoke_bench.png")
    r.save(png)
    m = r.step_metrics()
    fmt = lambda xs: ",".join(f"{x:.4f}" for x in xs)
    say("metrics", scatter_occupancy=fmt(m["scatter_occupancy"]),
        shadow_occupancy=fmt(m["shadow_occupancy"]),
        visits_per_lane=fmt(m["visits_per_lane"]),
        rr_lanes=f"{m['rr_lanes']:.0f}", image_mean=f"{hdr.mean():.5f}",
        png=os.path.relpath(png, HERE))

    ms_b, plain_b, _ = kernel_rows["bounce0"]
    ms_p, plain_p, _ = kernel_rows["primary"]
    print(json.dumps({"kernels": [{
        "name": "traverse4", "route": "cuda",
        "source": "fspt_tpu_torch/csrc/traverse4.cu",
        "replaces": "fspt_tpu/ops/traverse4.py:60",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_b, "plain_ms": plain_b,
        "primary_ms": ms_p, "primary_plain_ms": plain_p}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
