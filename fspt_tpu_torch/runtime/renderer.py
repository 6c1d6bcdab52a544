"""Progressive renderer: sample steps accumulated into a running sum (port of
fspt_tpu.runtime.renderer).

The accumulation state (sum, count) plus the RNG base seed is the
checkpoint.  The framebuffer is a (3, N) channel-planes tensor on the
render device, kept in tile order (runtime/layout.py) and un-permuted on
the host when an image is read.

`Renderer` takes its device explicitly: "cuda" by default, which raises
when no card is present; "cpu" runs the same path with the traversal
kernels' plain PyTorch versions (the CPU tests do so).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from fspt_tpu_torch.config import CameraConfig, PostConfig, RenderConfig
from fspt_tpu_torch.core import rng, vec
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import (check_config, trace_heatmap,
                                            trace_paths, trace_paths_batched)
from fspt_tpu_torch.core.tonemap import postprocess
from fspt_tpu_torch.core.traversal import intersect_scene
from fspt_tpu_torch.ops.traverse import check_stack_overflow
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


def sample_step(scene, cfg: RenderConfig, meta, cam: CameraState, accum,
                count, rays, base_key, sample_idx, resolution, pixel_idx):
    """One progressive sample batch: raygen -> trace -> accumulate.

    accum: (3, N) running radiance sum in pixel_idx order.  count, rays:
    0-d float32 tensors (rays counts active-lane rays actually traced).
    base_key: host key data (core/rng.py).  Returns (accum, count, rays)."""
    key = rng.sample_key(base_key, sample_idx)
    n = pixel_idx.shape[0]

    def rays_for(k):
        cam_u = rng.stream_uniforms(k, 0, (4, n), device=pixel_idx.device)
        return generate_rays(
            cam.position, cam.direction, cam.fov_scale, cam.focal_depth,
            cam.aperture, resolution, cam_u, pixel_idx=pixel_idx)

    if (cfg.wavefront_batch and cfg.compact and cfg.batch_spp > 1
            and cfg.mode != "bvh_heatmap"):
        # all batch_spp samples as one wavefront; tails share launches
        per = [rays_for(rng.fold_in(key, i)) for i in range(cfg.batch_spp)]
        origin = vec.cat([o for o, _ in per])
        direction = vec.cat([d for _, d in per])
        radiance, stats = trace_paths_batched(
            scene, cfg, meta, origin, direction, key, n_per=n,
            return_stats=True)
        accum = accum + torch.stack([radiance.x, radiance.y, radiance.z])
        return accum, count + cfg.batch_spp, rays + stats.rays

    for spp_i in range(cfg.batch_spp):
        k = rng.fold_in(key, spp_i)
        origin, direction = rays_for(k)
        if cfg.mode == "bvh_heatmap":
            radiance = trace_heatmap(scene, cfg, meta, origin, direction)
            rays = rays + float(n)
        else:
            radiance, stats = trace_paths(scene, cfg, meta, origin,
                                          direction, k, return_stats=True)
            rays = rays + stats.rays
        accum = accum + torch.stack([radiance.x, radiance.y, radiance.z])
    return accum, count + cfg.batch_spp, rays


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
        self._stats = {"samples": 0, "seconds": 0.0, "rays": 0.0}

    # ---- the reference's `dirty` restart (main.js:826-836 clear) -------
    def reset(self):
        n = self.cfg.width * self.cfg.height
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=self.device)
        self.accum = z(3, n)
        self.count = z()
        self.rays = z()
        self.sample_idx = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            check_stack_overflow(self.device)

    @torch.no_grad()
    def step(self, num_batches: int = 1):
        t0 = time.perf_counter()
        with span("step"):
            rays0 = float(self.rays)
            for _ in range(num_batches):
                self.accum, self.count, self.rays = sample_step(
                    self.arrays, self.cfg, self.scene.meta, self.camera,
                    self.accum, self.count, self.rays, self.base_key,
                    self.sample_idx, self.resolution, self.pixel_idx)
                self.sample_idx += 1
            self._sync()
            rays1 = float(self.rays)
        dt = time.perf_counter() - t0
        self._stats["samples"] += num_batches * self.cfg.batch_spp
        self._stats["seconds"] += dt
        self._stats["rays"] += rays1 - rays0
        return self

    def render(self, samples: Optional[int] = None):
        target = samples if samples is not None else self.scene.samples
        while float(self.count) < target:
            self.step()
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
        scatter/shadow lane fraction) and mean traversal visits per lane
        (TraceStats.visits over the lanes: per ray under "split", the
        group's shared count under "walk" and "packet")."""
        n = self.cfg.width * self.cfg.height
        k = rng.fold_in(rng.sample_key(self.base_key, sample_idx), 0)
        cam_u = rng.stream_uniforms(k, 0, (4, n), device=self.device)
        origin, direction = generate_rays(
            self.camera.position, self.camera.direction,
            self.camera.fov_scale, self.camera.focal_depth,
            self.camera.aperture, self.resolution, cam_u,
            pixel_idx=self.pixel_idx)
        _, st = trace_paths(self.arrays, self.cfg, self.scene.meta, origin,
                            direction, k, return_stats=True)
        self._sync()
        return {
            "rays": float(st.rays),
            "scatter_occupancy": (st.active.cpu().numpy() / n).tolist(),
            "shadow_occupancy": (st.shadow.cpu().numpy() / n).tolist(),
            "visits_per_lane": (st.visits.cpu().numpy() / n).tolist(),
            "rr_lanes": float(st.rr_lanes),
        }


def render(scene, config: Optional[RenderConfig] = None,
           samples: Optional[int] = None, device="cuda") -> np.ndarray:
    """One-shot render -> (H, W, 3) display image in [0, 1]."""
    r = Renderer(scene, config, device=device)
    r.render(samples)
    return r.image()
