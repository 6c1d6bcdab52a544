"""The traffic generator: one driver per `kind` of a mix file
(fsptbench/traffic/<mix>.json), each with a set-up, a measured window and
the correctness check of what its window produced.

  progressive  one client, closed loop: Renderer.step() back to back,
               accumulating, as a progressive render to the scene's sample
               count runs.  Mix keys: warmup_steps, trace_from_step,
               trace_steps, checked_steps (steps compared, at moments
               of the window drawn from the seed).
  drag         the interactive viewer under a continuous look-drag, open
               loop: events due at `rate_hz`, each handed to
               InteractiveViewer.handle_event on the driver thread while
               the viewer's own loop thread renders and publishes frames.
               Mix keys: rate_hz, dx, dy ([low, high] pixels an event:
               every seed sends the same deltas, spread evenly over
               the ranges, in an order drawn from the seed),
               warmup_previews, trace_at_s,
               trace_frames, checked_frames, wait_s.
  train        closed loop of train steps (make_train_step) with
               gradient descent.  Mix keys: lr, env_scale, emit (the
               start's ranges, drawn from the seed), first_steps,
               trace_from_step, trace_steps.

Every driver times by the host clock around work that ends synchronised
with the card, and hands the records of its window to the metric readers.
"""

from __future__ import annotations

import dataclasses
import io
import threading
import time

import numpy as np
import torch

from fsptbench import checks
from fsptbench.profiling import span
from fsptbench.reference.render import Reference
from fsptbench.reference.scene import compile_scene


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _reference(run, lowp=False):
    scene = compile_scene(run.scene_dict, run.assets, run.device)
    return scene, Reference(scene, run.ref_cfg, lowp=lowp)


# ---- progressive ---------------------------------------------------------

class Progressive:
    def __init__(self, run):
        self.run = run

    def setup(self):
        from fspt_tpu_torch import Renderer
        run = self.run
        self.r = Renderer(run.scene, run.cfg, device=run.device)
        for _ in range(run.mix["warmup_steps"]):
            self.r.step()
        a = self.r.arrays
        run.facts["table_bytes"] = (a.pk_nodes.numel() * 4
                                    + a.pk_leaves.numel() * 4)

    def window(self):
        run, r, mix = self.run, self.r, self.run.mix
        # the steps checked afterwards: those running at `checked_steps`
        # moments of the window drawn from the seed; only their
        # accumulations before and after are kept
        due = sorted(np.random.default_rng(run.seed).uniform(
            0.0, 0.9 * run.seconds, mix["checked_steps"]).tolist())
        self.kept = []
        traced = range(mix["trace_from_step"],
                       mix["trace_from_step"] + mix["trace_steps"])
        t0 = time.perf_counter()
        k = 0
        while True:
            if run.slice is not None and k == traced.start:
                run.slice.start()
            s0 = r.stats
            before, idx = r.accum, r.sample_idx
            ts = time.perf_counter()
            with span("Renderer.step"):
                r.step()
            te = time.perf_counter()
            s1 = r.stats
            run.records.append({"t0": ts - t0, "t1": te - t0,
                                "samples": s1["samples"] - s0["samples"],
                                "rays": s1["rays"] - s0["rays"]})
            if due and te - t0 > due[0]:
                self.kept.append((before, r.accum, idx))
                while due and te - t0 > due[0]:
                    due.pop(0)
            if run.slice is not None and k == traced.stop - 1:
                run.slice.stop()
            k += 1
            if te - t0 >= run.seconds and k >= traced.stop * (
                    run.slice is not None):
                break
        run.window_s = te - t0
        run.facts["step_ms"] = [round((r["t1"] - r["t0"]) * 1e3, 1)
                                for r in run.records]
        if run.slice is not None:
            done = [run.records[i] for i in traced]
            run.slice_work = {"steps": len(done),
                              "samples": sum(d["samples"] for d in done),
                              "rays": sum(d["rays"] for d in done)}
        run.attempted, run.failed = len(run.records), 0

    def check(self):
        """The checked steps: the radiance each added to the
        accumulation, against the reference's step."""
        run = self.run
        got = [((after.double() - before.double()).T.cpu().numpy(), idx)
               for before, after, idx in self.kept]
        spp, res = run.cfg.batch_spp, (run.cfg.width, run.cfg.height)
        del self.r, self.kept
        _free(run.device)
        scene, ref = _reference(run)
        readings = []
        for prog, sample_idx in got:
            want = ref.step(scene.camera, res, run.cfg.seed, sample_idx, spp)
            readings.append(checks.radiance_numbers(prog,
                                                    want.cpu().numpy()))
        return checks.worst(readings)


# ---- drag ----------------------------------------------------------------

def _rotate_y(v, a):
    c, s = np.cos(a), np.sin(a)
    x, y, z = v
    return np.array([c * x + s * z, y, -s * x + c * z], np.float32)


def _rotate_axis(v, axis, a):
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    c, s = np.cos(a), np.sin(a)
    return np.asarray(
        v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c),
        np.float32)


def look(direction: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """The view direction after one look event (main.js:641-643: yaw about
    world-Y, pitch about the view's right axis, 0.003 rad a pixel), as the
    float32 value the camera holds."""
    d = _rotate_y(np.asarray(direction, np.float32), -float(dx) * 0.003)
    right = np.cross(d, [0.0, 1.0, 0.0])
    d = _rotate_axis(d, right, -float(dy) * 0.003)
    d /= max(np.linalg.norm(d), 1e-12)
    return np.asarray(d, np.float32)


class _Tagged:
    """Instrumentation of the viewer's renderers: the camera one is given
    carries the number of the event that set it, and a step records the
    number of the camera it rendered with.  Reads on the thread that hands
    in the events (handle_event's own) record nothing."""

    @property
    def camera(self):
        cam, tag = self.__dict__["_bench_cam"]
        if threading.get_ident() != self.__dict__["_bench_events_thread"]:
            self.__dict__["_bench_used"] = tag
        return cam

    @camera.setter
    def camera(self, cam):
        self.__dict__["_bench_cam"] = (cam, self.__dict__.get(
            "_bench_next", -1))


class Drag:
    def __init__(self, run):
        self.run = run

    def setup(self):
        from fspt_tpu_torch.runtime.viewer import InteractiveViewer
        run, mix = self.run, self.run.mix
        v = InteractiveViewer(run.scene, run.cfg, device=run.device)
        p = v.preview
        tagged = type("TaggedRenderer", (_Tagged, type(p)), {})
        for r in (p, v.renderer):
            r.__class__ = tagged
            r.__dict__["_bench_cam"] = (r.__dict__.pop("camera"), -1)
            r.__dict__["_bench_events_thread"] = threading.get_ident()
        # (publish time, event tag, png bytes, preview): a full-size frame,
        # rendered once the drag has settled, shows its event too
        self.frames = []
        publish = v._publish

        def traced_publish(r, preview):
            with span("viewer.publish"):
                publish(r, preview)
            self.frames.append((time.perf_counter(),
                                r.__dict__.get("_bench_used", -1),
                                v.frame_png()[0], preview))
        v._publish = traced_publish
        step = p.step
        self.trace_state = "off"
        self.traced_frames = 0

        def traced_step(*a, **kw):
            # the profiler starts and stops on the loop thread, between
            # frames, while the viewer's lock keeps events out
            if self.trace_state == "start":
                self.traced_span = [time.perf_counter()]
                with v.lock:
                    run.slice.start()
                self.trace_state = "on"
            with span("viewer.preview"):
                out = step(*a, **kw)
            if self.trace_state == "on":
                self.traced_frames += 1
                if self.traced_frames >= mix["trace_frames"]:
                    with v.lock:
                        run.slice.stop()
                    self.traced_span.append(time.perf_counter())
                    self.trace_state = "done"
                    run.slice_work = {"frames": self.traced_frames}
            return out
        p.step = traced_step
        for _ in range(mix["warmup_previews"]):
            p.reset()
            p.step()
        v._publish(p, True)
        self.frames.clear()
        _sync(run.device)
        # every seed drags by the same set of deltas, spread evenly over
        # their ranges, in an order of its own: the seed changes the
        # camera's path and not the work
        rng = np.random.default_rng(run.seed)
        n = int(mix["rate_hz"] * run.seconds)
        even = (np.arange(n) + 0.5) / n
        self.events = np.stack(
            [rng.permutation(lo + (hi - lo) * even)
             for lo, hi in (mix["dx"], mix["dy"])], axis=1)
        self.start_dir = np.asarray(run.scene_dict["cameraDir"], np.float32)
        self.v = v

    def window(self):
        run, mix, v = self.run, self.run.mix, self.v
        # a still look event first, so that the loop starts in preview mode
        v.handle_event({"type": "look", "dx": 0.0, "dy": 0.0})
        v.start()
        t0 = time.perf_counter()
        sent = []
        due = t0 + np.arange(len(self.events)) / mix["rate_hz"]
        for e, (dx, dy) in enumerate(self.events):
            wait = due[e] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if (run.slice is not None and self.trace_state == "off"
                    and time.perf_counter() - t0 >= mix["trace_at_s"]):
                self.trace_state = "start"
            v.preview.__dict__["_bench_next"] = e
            v.renderer.__dict__["_bench_next"] = e
            sent.append(time.perf_counter())
            v.handle_event({"type": "look", "dx": float(dx),
                            "dy": float(dy)})
        last = len(self.events) - 1
        deadline = time.perf_counter() + mix["wait_s"]
        while (not any(f[1] >= last for f in self.frames)
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        t_end = time.perf_counter()
        v.stop()
        _sync(run.device)
        if self.trace_state == "on":
            run.slice.stop()
        if run.slice is not None and self.trace_state != "done":
            raise RuntimeError("the window ended before its traced slice")
        frames = [f for f in self.frames if f[0] <= t_end]
        # frames/s leaves out the profiler's own slice, from its start to
        # its stop
        a, b = (self.traced_span if run.slice is not None
                else (float("inf"), float("inf")))
        run.facts["frames_untraced"] = sum(f[3] and not a <= f[0] <= b
                                           for f in frames)
        run.facts["untraced_s"] = (t_end - t0) - (
            b - a if run.slice is not None else 0.0)
        for e in range(len(self.events)):
            shown = next((f[0] for f in frames if f[1] >= e), None)
            run.records.append({
                "due_s": due[e] - t0,
                "latency_s": (shown if shown is not None else t_end) - due[e],
                "shown": shown is not None})
        run.window_s = t_end - t0
        run.facts["frames_in_window"] = sum(f[3] for f in frames)
        gaps = np.diff([f[0] for f in frames if f[3]]) * 1e3
        if len(gaps):
            run.facts["frame_gap_ms"] = {
                q: float(np.percentile(gaps, q)) for q in (5, 50, 95)}
        run.attempted = len(self.events)
        run.failed = sum(not r["shown"] for r in run.records)
        run.facts["generator_late_ms_max"] = float(
            (np.asarray(sent) - due).max() * 1e3)

    def check(self):
        """Preview frames of the window drawn from the seed: the PNG the
        viewer published, against the reference's frame for the camera of
        the event it was rendered with."""
        from PIL import Image
        run = self.run
        shown = [f for f in self.frames if f[1] >= 0 and f[3]]
        rng = np.random.default_rng(run.seed)
        pick = sorted(rng.choice(len(shown), size=min(
            run.mix["checked_frames"], len(shown)), replace=False).tolist())
        got = [(shown[i][1], np.asarray(Image.open(io.BytesIO(shown[i][2]))
                                        .convert("RGB"))) for i in pick]
        pcfg = self.v.preview.cfg
        post = self.v.renderer.post
        dirs = [self.start_dir]
        for dx, dy in self.events:
            dirs.append(look(dirs[-1], dx, dy))
        del self.v
        _free(run.device)
        scene, ref = _reference(run)
        from fsptbench.reference.tonemap import frame
        readings = []
        scale = run.cfg.width // pcfg.width
        for tag, png in got:
            cam = dict(scene.camera, direction=dirs[tag + 1].tolist())
            hdr = ref.step(cam, (pcfg.width, pcfg.height), pcfg.seed, 0, 1)
            want = frame(hdr, pcfg.width, pcfg.height,
                         dataclasses.asdict(post))
            readings.append(checks.frame_numbers(png[::scale, ::scale],
                                                 want))
        return checks.worst(readings)


# ---- train ---------------------------------------------------------------

def perturbation(seed: int, mix: dict, texels: int):
    """The train run's starting point, drawn from the seed: a factor for
    every environment texel and channel, and one emittance for every
    triangle."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(*mix["env_scale"], size=(3, texels)).astype(np.float32)
    emit = rng.uniform(*mix["emit"], size=3).astype(np.float32)
    return scale, emit


def _leaf_gaps(prog, ref):
    """The worst leaf's gap between the program's and the reference's
    norms, against the larger of that leaf's reference norm and the median
    leaf's; leaves whose reference norm is under a thousandth of the
    median leaf's are left out."""
    med = float(np.median(ref))
    keep = [i for i, r in enumerate(ref) if r >= 1e-3 * med]
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in keep)


class Train:
    """Closed loop of train steps (parallel/dist.py make_train_step): one
    sample a step at the configuration's size, the L2 loss against a target
    rendered at the scene's parameters, gradient descent on the
    environment image and the emittance from a start drawn from the seed.
    Set-up drives the step object through its first steps; the window
    goes on with the same object."""

    FIELDS = ("env_rgb", "emit")

    def __init__(self, run):
        self.run = run

    def setup(self):
        from fspt_tpu_torch.core import rng
        from fspt_tpu_torch.parallel.dist import (make_train_step,
                                                  params_to_torch,
                                                  split_params)
        from fspt_tpu_torch.runtime.renderer import CameraState
        run, mix = self.run, self.run.mix
        dev = torch.device(run.device)
        sc = run.scene
        self.arrays = sc.to_torch(dev)
        self.cam = CameraState.from_config(sc.camera, dev)
        host = split_params(sc.arrays)
        self.cam_params = params_to_torch(
            {"position": sc.camera.position,
             "direction": sc.camera.direction}, dev)
        self.base = rng.key(run.seed)
        self.fn = make_train_step(run.cfg, sc.meta, device=run.device)
        truth = params_to_torch({f: host[f] for f in self.FIELDS}, dev)
        self.target = self.fn.render(truth, self.cam_params, self.arrays,
                                     self.cam, self.base, 0)
        scale, emit = perturbation(run.seed, mix, len(host["env_rgb"][0]))
        start = {"env_rgb": tuple(p * s for p, s in zip(host["env_rgb"],
                                                          scale)),
                 "emit": tuple(np.full_like(p, e) for p, e in
                               zip(host["emit"], emit))}
        self.params = params_to_torch(start, dev)
        self.states = [self._state()]
        self.losses = []
        self.step_idx = 1
        for _ in range(mix["first_steps"]):
            self.losses.append(self._step())
            self.states.append(self._state())

    def _state(self):
        return [p.detach().clone() for f in self.FIELDS
                for p in self.params[f]]

    def _step(self) -> float:
        loss, grads, _ = self.fn(self.params, self.cam_params, self.arrays,
                                 self.cam, self.target, self.base,
                                 self.step_idx)
        with torch.no_grad():
            for f in self.FIELDS:
                for p, g in zip(self.params[f], grads[f]):
                    p -= self.run.mix["lr"] * g
        self.step_idx += 1
        return float(loss)

    def window(self):
        run, mix = self.run, self.run.mix
        traced = range(mix["trace_from_step"],
                       mix["trace_from_step"] + mix["trace_steps"])
        t0 = time.perf_counter()
        k = 0
        while True:
            if run.slice is not None and k == traced.start:
                run.slice.start()
            ts = time.perf_counter()
            with span("train_step"):
                self._step()
            te = time.perf_counter()
            run.records.append({"t0": ts - t0, "t1": te - t0})
            if run.slice is not None and k == traced.stop - 1:
                run.slice.stop()
            k += 1
            if te - t0 >= run.seconds and k >= traced.stop * (
                    run.slice is not None):
                break
        run.window_s = te - t0
        if run.slice is not None:
            run.slice_work = {"steps": len(traced)}
        run.attempted, run.failed = len(run.records), 0

    def check(self):
        """The set-up's first steps against the reference's: each step's
        loss, the first gradient (from the state after one step), the
        change of the parameters over the steps, by leaf."""
        run, mix = self.run, self.run.mix
        lr = mix["lr"]
        states = [[t.cpu().numpy().astype(np.float64) for t in s]
                  for s in self.states]
        losses = self.losses
        del self.fn, self.params, self.arrays, self.target, self.states
        _free(run.device)
        ref_losses, ref_states = reference_train(
            run.scene_dict, run.assets, run.ref_cfg, mix, run.device)
        return train_numbers(losses, states, ref_losses, ref_states, lr)


def reference_train(scene_dict, assets, cfg, mix, device, lowp=False):
    """The reference's first steps from the same start: (losses, states),
    a state being the six leaves (env r, g, b, emit r, g, b)."""
    scene = compile_scene(scene_dict, assets, device)
    ref = Reference(scene, cfg, lowp=lowp)
    seed = cfg["seed"]
    res = (cfg["width"], cfg["height"])
    h, w = scene.env.shape[:2]
    t = scene.v0.shape[0]
    target = ref.sample(scene.camera, res, seed, 0).detach()
    scale, emit = perturbation(seed, mix, h * w)
    scale = torch.from_numpy(scale).to(scene.v0.device)
    env = torch.stack([scene.env[..., c].reshape(-1) * scale[c]
                       for c in range(3)], dim=-1).reshape(h, w, 3)
    env = env.detach().requires_grad_(True)
    em = torch.from_numpy(np.tile(emit, (t, 1))).to(scene.v0.device)
    em = em.requires_grad_(True)

    def state():
        return ([env[..., c].detach().reshape(-1).cpu().numpy()
                 .astype(np.float64) for c in range(3)]
                + [em[:, c].detach().cpu().numpy().astype(np.float64)
                   for c in range(3)])

    states, losses = [state()], []
    for i in range(1, mix["first_steps"] + 1):
        ref.env, ref.emit = env, em
        with torch.enable_grad():
            rad = ref.sample(scene.camera, res, seed, i)
            loss = torch.mean((rad - target) ** 2)
            g_env, g_em = torch.autograd.grad(loss, [env, em])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            env -= mix["lr"] * g_env
            em -= mix["lr"] * g_em
        states.append(state())
    return losses, states


def train_numbers(losses, states, ref_losses, ref_states, lr) -> dict:
    norm = lambda a: float(np.linalg.norm(a))
    g = [norm((a - b) / lr) for a, b in zip(states[0], states[1])]
    g_ref = [norm((a - b) / lr) for a, b in zip(ref_states[0], ref_states[1])]
    d = [norm(b - a) for a, b in zip(states[0], states[-1])]
    d_ref = [norm(b - a) for a, b in zip(ref_states[0], ref_states[-1])]
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "grad_gap": _leaf_gaps(g, g_ref),
            "change_gap": _leaf_gaps(d, d_ref)}


KINDS = {"progressive": Progressive, "drag": Drag, "train": Train}
