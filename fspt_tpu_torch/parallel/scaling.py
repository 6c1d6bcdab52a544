"""Scaling-efficiency meter for the sharded render step: port of
fspt_tpu.parallel.scaling.

Two numbers per mesh size:

* **load-balance efficiency** — total honest rays / (n_shards x max
  per-shard rays), from the per-shard TraceStats ray counts the sharded
  step returns.  The forward render's only collective is the all-reduce
  of those counts, so with one rank a card wall-clock scaling efficiency
  is load balance up to launch jitter: a card finishing early idles until
  the next step.  Deterministic and exact on any mesh, in one process or
  many.
* **wall-clock rays/s** — informational.  In one process a mesh of k
  shards runs them one after another on its one device; only a mesh of
  one rank a card measures scaling.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import torch
import torch.distributed as dist

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import rng
from fspt_tpu_torch.parallel.dist import (make_mesh, make_sharded_sample_step,
                                          shard_accum)
from fspt_tpu_torch.runtime.renderer import CameraState, _device


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    rays: float               # honest rays traced per step (all shards)
    max_shard_rays: float     # busiest shard's rays
    balance_efficiency: float  # rays / (n_devices * max_shard_rays)
    seconds: float            # wall-clock per step (informational)
    rays_per_s: float


@dataclasses.dataclass
class ScalingReport:
    points: List[ScalePoint]

    @property
    def efficiency(self) -> float:
        """Load-balance efficiency at the largest measured mesh."""
        return self.points[-1].balance_efficiency

    def table(self) -> str:
        lines = ["devices  rays/step  balance-eff  wall-ms  Mrays/s"]
        for p in self.points:
            lines.append(f"{p.n_devices:7d}  {p.rays:9.0f}  "
                         f"{p.balance_efficiency:11.3f}  "
                         f"{p.seconds * 1e3:7.1f}  "
                         f"{p.rays_per_s / 1e6:7.2f}")
        return "\n".join(lines)


def measure_scaling(scene, cfg: RenderConfig,
                    device_counts: Sequence[int] = (1, 2, 4, 8),
                    steps: int = 2, warmup: int = 1,
                    device=None) -> ScalingReport:
    """Run the sharded sample step on meshes of each size (on `device`,
    "cuda" by default) and report per-shard ray counts, balance efficiency
    and wall-clock.  A size that does not divide the pixel count or is not
    a multiple of the world size is skipped."""
    dev = _device("cuda" if device is None else device)
    arrays = scene.to_torch(dev)
    cam = CameraState.from_config(scene.camera, dev)
    n = cfg.width * cfg.height
    world = dist.get_world_size() if dist.is_initialized() else 1
    points = []
    for n_dev in device_counts:
        if n % n_dev or n_dev % world:
            continue
        mesh = make_mesh(n_dev, device=dev)
        step = make_sharded_sample_step(mesh, cfg, scene.meta)
        accum = shard_accum(torch.zeros((3, n)), mesh)
        count = torch.zeros((), device=dev)
        key = rng.key(cfg.seed)
        shard_rays = None
        for i in range(warmup):
            accum, count, shard_rays = step(arrays, cam, accum, count, key, i)
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            accum, count, shard_rays = step(arrays, cam, accum, count, key, i)
        # the step waits for its kernels, so the clock reads the work
        rays_per_shard = shard_rays.cpu().numpy()
        dt = (time.perf_counter() - t0) / steps
        total = float(rays_per_shard.sum())
        mx = float(rays_per_shard.max())
        points.append(ScalePoint(
            n_devices=n_dev, rays=total, max_shard_rays=mx,
            balance_efficiency=total / (n_dev * mx) if mx else 0.0,
            seconds=dt, rays_per_s=total / dt))
    return ScalingReport(points=points)
