"""The differentiable train step (inverse rendering): port of the train-step
half of fspt_tpu.parallel.dist, for one device.

The JAX version shards the framebuffer's pixel lanes over a device mesh,
takes `value_and_grad` of an L2 image loss on each shard and all-reduces
(pmean) the gradients.  Here the step runs on one device with the same lane
dealing (`_deal_chunks(n, 1)`), the same tile-order pixel ids and the same
global lane ids for the RNG, so its loss and gradients are those of the JAX
step on a one-device mesh.  Spreading it over several devices adds only a
process group and an all-reduce of the gradients (ROADMAP A6).

The gradient is `torch.autograd.grad` of the loss with respect to the
parameter leaves.  The integrator detaches what the JAX version
stop_gradients (core/integrator.py), so the two differentiate the same
expression: materials, atlas and env map through shading and texture
fetches, the camera through ray generation and the light-NEE geometry,
never through a hit distance or a discrete choice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import check_config, trace_paths
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops.traverse import check_stack_overflow
from fspt_tpu_torch.runtime.layout import tile_order
from fspt_tpu_torch.runtime.renderer import _device

PARAM_FIELDS = ("emit", "ior", "dielectric",
                "atlas_r", "atlas_g", "atlas_b", "env_rgb")
_V3_FIELDS = ("emit", "env_rgb")


def split_params(scene):
    """Trainable material/env parameters out of SceneArrays."""
    return {f: getattr(scene, f) for f in PARAM_FIELDS}


def merge_params(scene, params, cam, cam_params):
    scene = scene._replace(**params)
    cam = cam._replace(position=cam_params["position"],
                       direction=cam_params["direction"])
    return scene, cam


def _leaf(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32),
                        device=device).requires_grad_(True)


def params_to_torch(params_np, device):
    """A dict of numpy arrays (split_params of the JAX package's arrays
    after np.asarray, or of the port's host scene) -> the port's dict of
    float32 leaf tensors on `device` that require grad.  emit and env_rgb
    may come as V3 of (S,) planes or as one (3, S) array; either becomes a
    V3 of three leaves.  Works for the camera's {"position", "direction"}
    too."""
    out = {}
    for name, a in params_np.items():
        if name in _V3_FIELDS:
            out[name] = V3(*(_leaf(p, device) for p in a))
        else:
            out[name] = _leaf(a, device)
    return out


def _flat(tree) -> list:
    return [p for name in tree for p in (
        tree[name] if isinstance(tree[name], V3) else (tree[name],))]


def _unflat(tree, flat) -> dict:
    flat = iter(flat)
    return {name: (V3(*(next(flat) for _ in range(3)))
                   if isinstance(tree[name], V3) else next(flat))
            for name in tree}


def _deal_chunks(n: int, n_dev: int):
    """Round-robin chunk assignment of the canonical lane space to shards:
    packet-sized chunks of the tile order dealt over the shards, at least 8
    chunks a shard.  Returns (n,) int32 canonical lane ids in shard-major
    dealt order (shard s owns positions [s*local, (s+1)*local))."""
    local = n // n_dev
    chunk = max(1, min(1024, local // 8))
    while local % chunk:
        chunk //= 2
    n_chunks = n // chunk
    order = np.concatenate([np.arange(s, n_chunks, n_dev)
                            for s in range(n_dev)])
    return (np.arange(n, dtype=np.int32).reshape(n_chunks, chunk)[order]
            .reshape(-1))


def make_train_step(cfg: RenderConfig, meta, device: Optional[str] = None):
    """Returns train_step(params, cam_params, scene, cam, target, base_key,
    step_idx) -> (loss, grads, cam_grads) on `device` ("cuda" by default;
    raises when no card is present).

    params: split_params-shaped dict of leaf tensors that require grad
    (params_to_torch); cam_params: {"position", "direction"} likewise;
    scene: the port's SceneArrays on the device; cam: a CameraState
    (runtime/renderer.py); target: (3, N) in `step.pixel_order` (column j
    is pixel pixel_order[j]); base_key: host key data (core/rng.py).  The
    sample is keyed sample_key(base_key, step_idx), as in the JAX step.
    Returns the loss as a 0-d tensor and the gradients shaped like params
    and cam_params (zeros where the loss does not depend on a leaf).  On a
    card the step waits for its kernels and raises if a traversal stack
    overflowed (ops/traverse.py check_stack_overflow).

    The returned function carries `.pixel_order` and `.render(params,
    cam_params, scene, cam, base_key, step_idx)`, the forward alone."""
    check_config(cfg)
    dev = _device("cuda" if device is None else device)
    n = cfg.width * cfg.height
    resolution = (cfg.width, cfg.height)
    perm = np.asarray(tile_order(cfg.width, cfg.height), np.int32)
    lane_ids_all = _deal_chunks(n, 1)
    pixel_order = perm[lane_ids_all]
    lane_ids = torch.from_numpy(lane_ids_all).to(dev)
    pixel_idx = torch.from_numpy(pixel_order).to(dev)

    def radiance(params, cam_params, scene, cam, key):
        sc, c = merge_params(scene, params, cam, cam_params)
        cam_u = rng.stream_uniforms(key, 0, (4, n), lane_offset=lane_ids)
        origin, direction = generate_rays(
            c.position, c.direction, c.fov_scale, c.focal_depth, c.aperture,
            resolution, cam_u, pixel_idx=pixel_idx)
        r = trace_paths(sc, cfg, meta, origin, direction, key,
                        lane_offset=lane_ids)
        return torch.stack([r.x, r.y, r.z])

    def step(params, cam_params, scene, cam, target, base_key, step_idx):
        leaves = _flat(params) + _flat(cam_params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("train_step: every parameter must be a tensor "
                             "that requires grad (see params_to_torch)")
        key = rng.sample_key(base_key, step_idx)
        with torch.enable_grad():
            loss = torch.mean((radiance(params, cam_params, scene, cam, key)
                               - target) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        check_stack_overflow(dev)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        k = len(_flat(params))
        return (loss.detach(), _unflat(params, grads[:k]),
                _unflat(cam_params, grads[k:]))

    @torch.no_grad()
    def render(params, cam_params, scene, cam, base_key, step_idx):
        """The step's forward alone: its sample's (3, N) radiance in
        pixel_order (a target rendered with it makes the loss 0 at those
        parameters, the same key and step_idx)."""
        out = radiance(params, cam_params, scene, cam,
                       rng.sample_key(base_key, step_idx))
        check_stack_overflow(dev)
        return out

    step.pixel_order = pixel_order
    step.render = render
    return step
