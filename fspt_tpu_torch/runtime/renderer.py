"""Progressive renderer: sample steps accumulated into a running sum (port of
fspt_tpu.runtime.renderer).

The accumulation state (sum, count) plus the RNG base seed is the
checkpoint.  The framebuffer is a (3, N) channel-planes tensor on the
render device, kept in tile order (runtime/layout.py) and un-permuted on
the host when an image is read.

`Renderer` takes its device explicitly: "cuda" by default, which raises
when no card is present; "cpu" runs the same path with the traversal
kernels' plain PyTorch versions (the CPU tests do so).

On a card, `Renderer.step` runs its first sample batch eagerly, captures
a later one as a CUDA graph (`StepGraph`: raygen and trace, keyed by a
device table of the batch's keys) and replays that graph for every batch
after it, so the host launches one graph instead of the step's ~10^4
small kernels.  A capture costs the host about what three replays save,
so it waits for a step call that is not the renderer's first (a
progressive loop) or for a call with that many batches still to come; a
short one-shot render stays eager.  `Renderer.warm_up` captures at once (the
viewer does so before it serves events).
Its inputs are copies of the camera and scene tensors, refreshed before a
replay wherever `Renderer.camera` or `Renderer.arrays` holds another
tensor of the same shape; another shape, config or scene is captured
anew.  The scene's tables (core/integrator.py scene_tables: the 2 GB
material table of a textured scene among them) are built from the copies
outside the graph, once a capture and again wherever a scene tensor was
copied, and the graph reads them as inputs: a replay asks no gradient, so
none is lost, and rebuilds nothing.  The accumulation stays outside the
graph, so every step binds `accum` to a new tensor as the eager step
does.  `sample_step` stays the
eager path (the CPU's, and the oracle the card's tests hold replays to).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from fspt_tpu_torch.config import CameraConfig, PostConfig, RenderConfig
from fspt_tpu_torch.core import rng, vec
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import (check_config, scene_tables,
                                            trace_heatmap, trace_paths,
                                            trace_paths_batched)
from fspt_tpu_torch.core.tonemap import postprocess
from fspt_tpu_torch.core.traversal import intersect_scene
from fspt_tpu_torch.ops.pcg4d import pcg4d_uniforms
from fspt_tpu_torch.ops.traverse import check_stack_overflow, packet_traverse
from fspt_tpu_torch.ops.traverse3 import packet_traverse3
from fspt_tpu_torch.ops.traverse4 import packet_traverse4
from fspt_tpu_torch.runtime.layout import tile_order, untile
from fspt_tpu_torch.trace import span


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Renderer(device='cuda'): CUDA is not available; "
                           "pass device='cpu' to render on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class CameraState(NamedTuple):
    """Runtime-tunable camera: 0-d / (3,) float32 tensors on the device."""

    position: torch.Tensor
    direction: torch.Tensor
    fov_scale: torch.Tensor
    focal_depth: torch.Tensor
    aperture: torch.Tensor

    @classmethod
    def from_config(cls, c: CameraConfig, device):
        f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return cls(position=f(c.position), direction=f(c.direction),
                   fov_scale=f(c.fov_scale), focal_depth=f(c.focal_depth),
                   aperture=f(c.aperture))


def counts_light(cfg: RenderConfig) -> bool:
    """Whether a renderer's ray count is a (2,) tensor [rays, light
    shadow rays] (light NEE on a path trace) rather than a 0-d one."""
    return cfg.use_light_nee and cfg.mode == "render"


def _sample_terms(scene, cfg: RenderConfig, meta, cam: CameraState,
                  sample_keys, batch_key, resolution, pixel_idx,
                  tables=None):
    """Raygen and trace of one sample batch: cfg.batch_spp samples, sample
    i keyed sample_keys[i] (host key data or a (2,) int64 device row);
    batch_key is what trace_paths_batched takes; tables, the scene's
    tables built ahead, or None (the traces build them).  Returns
    (radiance, rays): the (3, N) radiance terms and the ray counts that
    `_accumulate` adds (with counts_light(cfg), each [rays, light shadow
    rays]), one each for the wavefront batch, one a sample otherwise."""
    n = pixel_idx.shape[0]
    if counts_light(cfg):
        count = lambda st: torch.stack([st.rays, st.light.sum()])
    else:
        count = lambda st: st.rays

    def rays_for(k):
        cam_u = rng.stream_uniforms(k, 0, (4, n), device=pixel_idx.device)
        return generate_rays(
            cam.position, cam.direction, cam.fov_scale, cam.focal_depth,
            cam.aperture, resolution, cam_u, pixel_idx=pixel_idx)

    planes = lambda v: torch.stack([v.x, v.y, v.z])
    if (cfg.wavefront_batch and cfg.compact and cfg.batch_spp > 1
            and cfg.mode != "bvh_heatmap"):
        # all batch_spp samples as one wavefront; tails share launches
        per = [rays_for(sample_keys[i]) for i in range(cfg.batch_spp)]
        origin = vec.cat([o for o, _ in per])
        direction = vec.cat([d for _, d in per])
        radiance, stats = trace_paths_batched(
            scene, cfg, meta, origin, direction, batch_key, n_per=n,
            return_stats=True, tables=tables)
        return [planes(radiance)], [count(stats)]

    radiance, rays = [], []
    for spp_i in range(cfg.batch_spp):
        k = sample_keys[spp_i]
        origin, direction = rays_for(k)
        if cfg.mode == "bvh_heatmap":
            radiance.append(planes(trace_heatmap(scene, cfg, meta, origin,
                                                 direction)))
            rays.append(float(n))
        else:
            r, stats = trace_paths(scene, cfg, meta, origin, direction, k,
                                   return_stats=True, tables=tables)
            radiance.append(planes(r))
            rays.append(count(stats))
    return radiance, rays


def _accumulate(cfg: RenderConfig, accum, count, rays, radiance, ray_counts):
    """Add one sample batch's terms, in sample order."""
    for r in radiance:
        accum = accum + r
    for r in ray_counts:
        rays = rays + r
    return accum, count + cfg.batch_spp, rays


def sample_step(scene, cfg: RenderConfig, meta, cam: CameraState, accum,
                count, rays, base_key, sample_idx, resolution, pixel_idx):
    """One progressive sample batch: raygen -> trace -> accumulate.

    accum: (3, N) running radiance sum in pixel_idx order.  count: a 0-d
    float32 tensor; rays: the active-lane rays actually traced, 0-d, or
    with counts_light(cfg) (2,) [rays, light shadow rays].
    base_key: host key data (core/rng.py).  Returns (accum, count, rays)."""
    key = rng.sample_key(base_key, sample_idx)
    terms = _sample_terms(scene, cfg, meta, cam,
                          [rng.fold_in(key, i) for i in range(cfg.batch_spp)],
                          key, resolution, pixel_idx)
    return _accumulate(cfg, accum, count, rays, *terms)


def _leaves(tree) -> list:
    """The tensors of a (nested) NamedTuple, in field order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _clone(tree):
    if isinstance(tree, tuple):
        return type(tree)(*map(_clone, tree))
    return tree.clone() if torch.is_tensor(tree) else tree


def refresh_inputs(static: list, seen: list, leaves: list) -> Optional[bool]:
    """Bring a graph's static input tensors up to `leaves`: copy each leaf
    that is not the tensor copied last time (`seen`, updated).  Returns
    whether a leaf was copied; None where a leaf differs in shape, dtype
    or device, or is no tensor, so that the graph must be captured
    again."""
    if len(leaves) != len(static):
        return None
    copied = False
    for i, (dst, new) in enumerate(zip(static, leaves)):
        if new is seen[i]:
            continue
        if not (torch.is_tensor(new) and new.shape == dst.shape
                and new.dtype == dst.dtype and new.device == dst.device):
            return None
        dst.copy_(new)
        seen[i] = new
        copied = True
    return copied


# the launch counters a replay advances as the captured step did
_COUNTERS = (packet_traverse4, packet_traverse3, packet_traverse,
             pcg4d_uniforms, scene_tables)
# and the traversal ops' lane counters (ops/traverse.py count_lanes)
_LANE_COUNTERS = (packet_traverse4, packet_traverse3, packet_traverse)


def lanes_launched() -> int:
    """The rays handed to the traversal ops so far, replays included."""
    return sum(c.lanes for c in _LANE_COUNTERS)


class StepGraph:
    """One sample batch of a Renderer as a CUDA graph, and the static inputs
    it reads: the (batch_spp, 2) int64 key table (`set_keys`), copies of
    the camera and scene tensors (brought up to date by `holds`) and the
    scene's tables built from the copies (`tables`).  The outputs,
    `radiance` and `rays`, are overwritten by each replay; the caller
    accumulates them before the next.  `run_body` is what the graph holds,
    traced eagerly from the static inputs."""

    def __init__(self, r: "Renderer"):
        self.cfg, self.meta = r.cfg, r.scene.meta
        self.resolution, self.pixel_idx = r.resolution, r.pixel_idx
        self.keys = torch.zeros((self.cfg.batch_spp, 2), dtype=torch.int64,
                                device=r.device)
        self.camera, self.arrays = _clone(r.camera), _clone(r.arrays)
        self._camera = (_leaves(self.camera), _leaves(r.camera))
        self._arrays = (_leaves(self.arrays), _leaves(r.arrays))
        self.tables = scene_tables(self.arrays, self.cfg, self.meta)
        self._capture()

    def run_body(self):
        """(radiance, rays) of the batch keyed by the table, from the
        static inputs."""
        return _sample_terms(self.arrays, self.cfg, self.meta, self.camera,
                             self.keys, self.keys, self.resolution,
                             self.pixel_idx, self.tables)

    def _capture(self):
        t0 = time.perf_counter()
        # the wrappers count a captured launch apart (ops/traverse.py
        # count_launch); each replay launches it again
        before = [c.captured for c in _COUNTERS]
        lanes = [c.lanes_captured for c in _LANE_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the viewer's event thread may use the card meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.radiance, self.rays = self.run_body()
        self.launches = tuple(c.captured - b
                              for c, b in zip(_COUNTERS, before))
        self.lanes = tuple(c.lanes_captured - b
                           for c, b in zip(_LANE_COUNTERS, lanes))
        self.capture_s = time.perf_counter() - t0

    def holds(self, r: "Renderer") -> bool:
        """Whether this graph serves r's config and scene, its static
        inputs brought up to r.camera and r.arrays, and its tables rebuilt
        in place where a scene tensor was copied."""
        if r.cfg is not self.cfg or r.scene.meta is not self.meta:
            return False
        if refresh_inputs(*self._camera, _leaves(r.camera)) is None:
            return False
        copied = refresh_inputs(*self._arrays, _leaves(r.arrays))
        if copied is None:
            return False
        if copied:
            new = scene_tables(self.arrays, self.cfg, self.meta)
            for dst, src in zip(_leaves(self.tables), _leaves(new)):
                if dst is not None:
                    dst.copy_(src)
        return True

    def set_keys(self, base_key, sample_idx: int):
        """Write the key table of sample batch `sample_idx`: row i the key
        data of fold_in(sample_key(base_key, sample_idx), i)."""
        rows = rng.key_rows_for(rng.sample_key(base_key, sample_idx),
                                self.cfg.batch_spp).astype(np.int64)
        self.keys.copy_(torch.from_numpy(rows))

    def replay(self):
        with span("replay"):
            self.graph.replay()
        for c, k in zip(_COUNTERS, self.launches):
            c.launches += k
        for c, k in zip(_LANE_COUNTERS, self.lanes):
            c.lanes += k


# the batches still to come in a step call that repay a capture: one-shot
# renders at the bench's and the CLI's settings, all eager against a capture
# at the second batch, break even at 4-5 batches (PERF.md, Findings)
CAPTURE_AHEAD = 3


class Renderer:
    """Progressive path-tracing session over one scene on one device."""

    def __init__(self, scene, config: Optional[RenderConfig] = None,
                 camera: Optional[CameraConfig] = None,
                 post: Optional[PostConfig] = None, device="cuda"):
        self.device = _device(device)
        self.scene = scene
        self.cfg = config or RenderConfig()
        check_config(self.cfg)
        self.camera = CameraState.from_config(camera or scene.camera,
                                              self.device)
        self.post = post or scene.post
        self.arrays = scene.to_torch(self.device)
        self.resolution = (self.cfg.width, self.cfg.height)
        self.pixel_idx = torch.from_numpy(
            tile_order(self.cfg.width, self.cfg.height)).to(self.device)
        self.base_key = rng.key(self.cfg.seed)
        self.reset()
        self._stats = {"samples": 0, "seconds": 0.0, "rays": 0.0,
                       "light_rays": 0.0, "graph_captures": 0,
                       "graph_replays": 0, "table_builds": 0,
                       "lanes_launched": 0}
        # on a card: the first sample batch runs eagerly (the warm-up), a
        # later one is captured as a CUDA graph (_graph_due), and replays
        # run every batch after it
        self._graphs = self.device.type == "cuda"
        self._graph: Optional[StepGraph] = None
        self._warm = False
        self._stepped = False

    # ---- the reference's `dirty` restart (main.js:826-836 clear) -------
    def reset(self):
        n = self.cfg.width * self.cfg.height
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
        self.accum = z(3, n)
        self.count = z()
        self.rays = z(2) if counts_light(self.cfg) else z()
        self._rays_read = self._light_read = 0.0
        self.sample_idx = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            check_stack_overflow(self.device)

    def _capture(self):
        self._graph = None                      # free its pool first
        self._graph = StepGraph(self)
        self._stats["graph_captures"] += 1

    def _graph_due(self, first_call: bool, after: int) -> bool:
        """Whether a batch replays the graph, `after` batches of its step
        call still to come: once a batch has run eagerly on the card, where
        a graph exists or pays for its capture, in a progressive loop (not
        the first step call) or before CAPTURE_AHEAD more batches."""
        return self._warm and (self._graph is not None or not first_call
                               or after >= CAPTURE_AHEAD)

    def _replay(self):
        """One sample batch from the CUDA graph, captured first where none
        serves the current config, scene and input shapes."""
        if self._graph is None or not self._graph.holds(self):
            self._capture()
        g = self._graph
        g.set_keys(self.base_key, self.sample_idx)
        g.replay()
        self._stats["graph_replays"] += 1
        self.accum, self.count, self.rays = _accumulate(
            self.cfg, self.accum, self.count, self.rays, g.radiance, g.rays)

    @torch.no_grad()
    def warm_up(self):
        """On a card, make the step's graph now: an eager batch (the
        warm-up, its result discarded) where none ran yet, then the
        capture, so that no later step waits for either.  Leaves the
        accumulation alone; nothing to do on the CPU or with a graph."""
        if self._graphs and self._graph is None:
            builds, lanes = scene_tables.launches, lanes_launched()
            if not self._warm:
                sample_step(self.arrays, self.cfg, self.scene.meta,
                            self.camera, self.accum, self.count, self.rays,
                            self.base_key, self.sample_idx, self.resolution,
                            self.pixel_idx)
                self._sync()
                self._warm = True
            self._capture()
            self._stats["table_builds"] += scene_tables.launches - builds
            self._stats["lanes_launched"] += lanes_launched() - lanes
        return self

    @torch.no_grad()
    def step(self, num_batches: int = 1):
        t0 = time.perf_counter()
        builds, lanes = scene_tables.launches, lanes_launched()
        first_call, self._stepped = not self._stepped, True
        with span("step"):
            for i in range(num_batches):
                if self._graph_due(first_call, num_batches - 1 - i):
                    self._replay()
                else:
                    self.accum, self.count, self.rays = sample_step(
                        self.arrays, self.cfg, self.scene.meta, self.camera,
                        self.accum, self.count, self.rays, self.base_key,
                        self.sample_idx, self.resolution, self.pixel_idx)
                    self._warm = self._graphs
                self.sample_idx += 1
            self._sync()
            # one read of the counts: [rays, light rays] or rays alone
            if counts_light(self.cfg):
                rays, light = self.rays.tolist()
            else:
                rays, light = float(self.rays), 0.0
        dt = time.perf_counter() - t0
        self._stats["samples"] += num_batches * self.cfg.batch_spp
        self._stats["seconds"] += dt
        self._stats["rays"] += rays - self._rays_read
        self._stats["light_rays"] += light - self._light_read
        self._rays_read, self._light_read = rays, light
        self._stats["table_builds"] += scene_tables.launches - builds
        self._stats["lanes_launched"] += lanes_launched() - lanes
        return self

    def render(self, samples: Optional[int] = None):
        """Step until `samples` (the scene's own count by default) are
        accumulated, in one step call: it knows how many batches follow."""
        target = samples if samples is not None else self.scene.samples
        left = -(-int(target - float(self.count)) // self.cfg.batch_spp)
        if left > 0:
            self.step(left)
        return self

    # ---- outputs --------------------------------------------------------
    def _mean_planes(self) -> np.ndarray:
        mean = (self.accum / torch.clamp(self.count, min=1.0)).cpu().numpy()
        return untile(mean, self.cfg.width, self.cfg.height)  # (3, H, W)

    def hdr_image(self) -> np.ndarray:
        """(H, W, 3) mean radiance (row-major image order)."""
        return np.moveaxis(self._mean_planes(), 0, -1)

    @torch.no_grad()
    def image(self) -> np.ndarray:
        hdr = torch.from_numpy(self._mean_planes()).to(self.device)
        out = postprocess(hdr, exposure=self.post.exposure,
                          saturation=self.post.saturation,
                          denoise=self.post.denoise,
                          max_sigma=self.post.max_sigma,
                          gamma=self.post.gamma)
        return np.moveaxis(out.cpu().numpy(), 0, -1)

    def save(self, path: str):
        from fspt_tpu_torch.io.image import write_png
        write_png(path, self.image())
        return self

    # ---- interactive preview (reference main.js:841 resScale=0.25) -----
    def preview(self, scale: float = 0.25, samples: int = 1) -> np.ndarray:
        """Quick low-resolution render at the current camera (the
        reference's quarter-res while-moving mode), leaving the progressive
        accumulation alone.  The sub-renderer is cached per (width,
        height)."""
        import dataclasses
        w = max(int(self.cfg.width * scale) // 8 * 8, 16)
        h = max(int(self.cfg.height * scale) // 8 * 8, 16)
        if not hasattr(self, "_preview_cache"):
            self._preview_cache = {}
        r = self._preview_cache.get((w, h))
        if r is None:
            cfg = dataclasses.replace(self.cfg, width=w, height=h,
                                      batch_spp=1)
            r = Renderer(self.scene, cfg, post=self.post, device=self.device)
            self._preview_cache[(w, h)] = r
        r.reset()
        r.camera = self.camera
        r.post = self.post
        r.step(samples)
        return r.image()

    # ---- autofocus (reference main.js:447-546 shootAutoFocusRay) -------
    @torch.no_grad()
    def autofocus(self, px: Optional[int] = None, py: Optional[int] = None):
        """Set the focal depth to the hit distance under the given pixel
        (the view centre by default), by the per-ray binary-BVH walk of
        core/traversal (the reference repeats the walk on the CPU)."""
        if px is None:
            origin = self.camera.position[None, :]
            direction = self.camera.direction[None, :]
        else:
            n = self.cfg.width * self.cfg.height
            cam_u = torch.zeros((4, n), dtype=torch.float32,
                                device=self.device)
            f32 = lambda x: torch.tensor(x, dtype=torch.float32,
                                         device=self.device)
            o, d = generate_rays(self.camera.position, self.camera.direction,
                                 self.camera.fov_scale, f32(1e6), f32(0.0),
                                 self.resolution, cam_u)
            idx = py * self.cfg.width + px
            origin = vec.to_array(o)[idx:idx + 1]
            direction = vec.to_array(d)[idx:idx + 1]
        with span("traverse"):
            hit = intersect_scene(self.arrays, origin, direction,
                                  leaf_size=self.scene.leaf_size,
                                  stack_depth=self.cfg.stack_depth)
        t = float(hit.t[0])
        if t < self.cfg.max_t:
            self.camera = self.camera._replace(
                focal_depth=torch.tensor(t, dtype=torch.float32,
                                         device=self.device))
        return t

    # ---- checkpoint / resume -------------------------------------------
    def save_checkpoint(self, path: str):
        np.savez(path, accum=self.accum.cpu().numpy(),
                 count=self.count.cpu().numpy(), sample_idx=self.sample_idx,
                 seed=self.cfg.seed)
        return self

    def load_checkpoint(self, path: str):
        data = np.load(path)
        if int(data["seed"]) != self.cfg.seed:
            raise ValueError(f"checkpoint seed {int(data['seed'])} != "
                             f"config seed {self.cfg.seed}")
        self.accum = torch.from_numpy(data["accum"]).to(self.device)
        self.count = torch.from_numpy(data["count"]).to(self.device)
        self.sample_idx = int(data["sample_idx"])
        return self

    # ---- metrics ----------------------------------------------------------
    @property
    def stats(self):
        s = dict(self._stats)
        # "rays" counts the active-lane rays traced, "light_rays" the light
        # shadow rays among them (0 without light NEE); "table_builds" the
        # builds of the scene's tables the steps ran: in every eager trace,
        # once a capture or scene refresh of a graph, none in a replay;
        # "lanes_launched" the rays the steps handed to the traversal
        # ops, parked lanes included (host counts of the launches'
        # shapes): without compaction, lane_rays_upper_bound
        n = self.cfg.width * self.cfg.height
        # upper bound: every launch's full lane count (primary + batched
        # scatter + env shadow, + light shadow when light NEE is on);
        # heatmap mode traces only the primary launch
        if self.cfg.mode == "bvh_heatmap":
            s["lane_rays_upper_bound"] = s["samples"] * n
        else:
            segs = 3 if self.cfg.use_light_nee else 2
            s["lane_rays_upper_bound"] = (
                s["samples"] * n * (1 + segs * self.cfg.max_iters))
        if s["seconds"] > 0:
            # honest throughput: active-lane rays actually traced per second
            s["rays_per_s"] = s["rays"] / s["seconds"]
            s["spp_per_s"] = s["samples"] / s["seconds"]
        return s

    def profile_trace(self, logdir: str, num_batches: int = 1):
        """Capture a torch.profiler trace of `num_batches` sample steps into
        `logdir` as a Chrome trace (`*.pt.trace.json`, viewable in
        TensorBoard or chrome://tracing): the host's ops, and on the card
        every kernel of the process, the traversal kernels launched through
        ctypes included.  The steps are one `fspt.step` span, the program's
        phases spans inside it (fspt_tpu_torch/trace.py)."""
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)):
            self.step(num_batches)
        return self

    @torch.no_grad()
    def step_metrics(self, sample_idx: int = 0):
        """Per-bounce metrics for one unbatched sample: occupancy (live
        scatter/shadow lane fraction; of the shadow lanes, the light ones
        (None without light NEE); the lanes that took the refraction
        branch) and mean traversal visits per lane (TraceStats.visits over
        the lanes: per ray under "split", the group's shared count under
        "walk" and "packet")."""
        n = self.cfg.width * self.cfg.height
        k = rng.fold_in(rng.sample_key(self.base_key, sample_idx), 0)
        cam_u = rng.stream_uniforms(k, 0, (4, n), device=self.device)
        origin, direction = generate_rays(
            self.camera.position, self.camera.direction,
            self.camera.fov_scale, self.camera.focal_depth,
            self.camera.aperture, self.resolution, cam_u,
            pixel_idx=self.pixel_idx)
        _, st = trace_paths(self.arrays, self.cfg, self.scene.meta, origin,
                            direction, k, return_stats=True,
                            count_refracted=True)
        self._sync()
        share = lambda c: None if c is None else (c.cpu().numpy()
                                                  / n).tolist()
        return {
            "rays": float(st.rays),
            "scatter_occupancy": share(st.active),
            "shadow_occupancy": share(st.shadow),
            "light_occupancy": share(st.light),
            "refracted_occupancy": share(st.refracted),
            "visits_per_lane": share(st.visits),
            "rr_lanes": float(st.rr_lanes),
        }


def render(scene, config: Optional[RenderConfig] = None,
           samples: Optional[int] = None, device="cuda") -> np.ndarray:
    """One-shot render -> (H, W, 3) display image in [0, 1]."""
    r = Renderer(scene, config, device=device)
    r.render(samples)
    return r.image()
