"""Sharded render and differentiable train steps over a mesh of shards:
port of fspt_tpu.parallel.dist over torch.distributed.

JAX's model is kept: a mesh is `size` shards of the framebuffer's pixel
lanes, and each process holds a consecutive block of them.  In torch idiom
one process is one rank of a process group, and it drives one device, on
which it runs its shards one after another:
  * without a process group, one process holds every shard;
  * with a group of world size W, each rank holds size / W shards.
Several cards are several ranks, one a card (parallel/multihost.py).
Each shard ray-gens and traces only its own lanes, with the scene
replicated; the forward render needs no collective, since the shards'
columns are disjoint.  The train step takes an L2 image loss on each shard
and averages loss and gradients over the shards (JAX's pmean): a sum over
the shards held here, an all-reduce over the group, a division by size.

Every collective is a SUM all-reduce: gloo supports all_reduce and
broadcast on CUDA tensors but not all_gather, so one code path serves gloo
on the CPU, gloo on a card and NCCL.  The RNG is keyed by the canonical
lane id (core/rng.py), never by shard, so a sharded render equals the
single-device renderer's per pixel.

The gradient is `torch.autograd.grad` of the loss with respect to the
parameter leaves.  The integrator detaches what the JAX version
stop_gradients (core/integrator.py), so the two differentiate the same
expression: materials, atlas and env map through shading and texture
fetches, the camera through ray generation and the light-NEE geometry,
never through a hit distance or a discrete choice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import rng
from fspt_tpu_torch.core.camera import generate_rays
from fspt_tpu_torch.core.integrator import check_config, trace_paths
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops.traverse import check_stack_overflow
from fspt_tpu_torch.runtime.layout import tile_order
from fspt_tpu_torch.runtime.renderer import _device
from fspt_tpu_torch.trace import span

PARAM_FIELDS = ("emit", "ior", "dielectric",
                "atlas_r", "atlas_g", "atlas_b", "env_rgb")
_V3_FIELDS = ("emit", "env_rgb")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `size` shards.  This process holds the consecutive
    shards `shards` and runs them one after another on `device`; `group` is
    the process group the mesh spans (None: this process holds every
    shard)."""

    size: int
    shards: tuple
    device: torch.device
    group: Optional[object]
    axis_name: str = "rays"


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "rays",
              device=None) -> Mesh:
    """A mesh of `num_devices` shards over the default process group, or
    over this process alone when none is initialised.  device: "cuda" by
    default (raises when no card is present; without an index, the current
    card) or "cpu".  num_devices defaults to one shard a process.  A size
    the world size does not divide raises."""
    dev = _device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    group = (dist.group.WORLD
             if dist.is_available() and dist.is_initialized() else None)
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    size = world if num_devices is None else int(num_devices)
    if size < 1 or size % world:
        raise ValueError(f"a mesh of {size} shards over {world} processes: "
                         "the world size must divide the mesh size")
    per = size // world
    return Mesh(size=size, shards=tuple(range(rank * per, (rank + 1) * per)),
                device=dev, group=group, axis_name=axis_name)


def shard_accum(accum, mesh: Mesh) -> list:
    """The global (3, N) buffer (dealt order, as `step.pixel_order`) ->
    this process's columns: one (3, N / size) tensor a shard it holds, on
    the mesh's device (the counterpart of jax.device_put with
    P(None, axis))."""
    accum = torch.as_tensor(accum, dtype=torch.float32)
    n = accum.shape[1]
    if n % mesh.size:
        raise ValueError(f"{n} columns not divisible by {mesh.size} shards")
    local = n // mesh.size
    return [accum[:, s * local:(s + 1) * local].to(mesh.device).clone()
            for s in mesh.shards]


def gather_accum(local, mesh: Mesh) -> torch.Tensor:
    """The whole (3, N) buffer on every rank, on the mesh's device (the
    counterpart of process_allgather(..., tiled=True)): each
    rank writes its columns into zeros and the ranks all-reduce the sum,
    which is exact for the non-negative radiance sums."""
    n_local = local[0].shape[1]
    out = torch.zeros((3, n_local * mesh.size), dtype=torch.float32,
                      device=mesh.device)
    for s, t in zip(mesh.shards, local):
        out[:, s * n_local:(s + 1) * n_local] = t
    if mesh.group is not None:
        dist.all_reduce(out, group=mesh.group)
    return out


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


class _Lanes:
    """The dealt lanes of a mesh: `pixel_order` (global), `columns` (this
    process's slice of it), and a shard's canonical lane ids and pixel ids
    on the mesh's device."""

    def __init__(self, mesh: Mesh, cfg: RenderConfig):
        n = cfg.width * cfg.height
        if n % mesh.size:
            raise ValueError(f"pixels {n} not divisible by {mesh.size} "
                             "devices")
        self.local = n // mesh.size
        lane_ids = _deal_chunks(n, mesh.size)
        perm = np.asarray(tile_order(cfg.width, cfg.height), np.int32)
        self.pixel_order = perm[lane_ids]
        self.columns = slice(mesh.shards[0] * self.local,
                             (mesh.shards[-1] + 1) * self.local)

        def per_shard(ids):
            return [torch.from_numpy(ids[s * self.local:(s + 1) * self.local])
                    .to(mesh.device) for s in mesh.shards]

        self.lane_ids = per_shard(lane_ids)
        self.pixel_idx = per_shard(self.pixel_order)


def _wait(mesh: Mesh):
    """On a card, wait for the shards' kernels and raise if a traversal
    stack overflowed (ops/traverse.py)."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
        check_stack_overflow(mesh.device)


def _tree_sum(xs):
    """Pairwise sum ((x0 + x1) + (x2 + x3)): a power-of-two block of shards
    per rank then sums in the association the all-reduce continues."""
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] if i + 1 < len(xs) else xs[i]
              for i in range(0, len(xs), 2)]
    return xs[0]


def make_sharded_sample_step(mesh: Mesh, cfg: RenderConfig, meta):
    """Returns step(scene, cam, accum, count, base_key, sample_idx) ->
    (accum, count, shard_rays).

    scene: the port's SceneArrays, cam: a CameraState (runtime/renderer.py),
    both on the mesh's device; accum: this
    process's columns (shard_accum), returned likewise; count: a 0-d
    tensor, bumped by cfg.batch_spp; base_key: host key data (core/rng.py).
    shard_rays: (size,) float32, the honest active-lane rays each shard
    traced this step (TraceStats), the same on every rank: the input of the
    load-balance meter in parallel/scaling.py.  Like the JAX step, it
    traces cfg.batch_spp samples one after another (no wavefront batch).
    On a card the step waits for its kernels and raises if a traversal
    stack overflowed.

    The returned function carries `.pixel_order`: column j of the global
    buffer (gather_accum) holds the radiance sum of pixel pixel_order[j]
    (shard-dealt chunk order, NOT the single-device renderer's tile order;
    scatter by pixel id to compare), and `.columns`, the slice of it this
    process owns."""
    check_config(cfg)
    lanes = _Lanes(mesh, cfg)
    local = lanes.local
    resolution = (cfg.width, cfg.height)

    @torch.no_grad()
    def step(scene, cam, accum, count, base_key, sample_idx):
        key = rng.sample_key(base_key, sample_idx)
        shard_rays = torch.zeros(mesh.size, dtype=torch.float32,
                                 device=mesh.device)
        out = []
        for j, s in enumerate(mesh.shards):
            lane_ids, pixel_idx = lanes.lane_ids[j], lanes.pixel_idx[j]
            acc = accum[j]
            rays = torch.zeros((), dtype=torch.float32, device=mesh.device)
            for spp_i in range(cfg.batch_spp):
                k = rng.fold_in(key, spp_i)
                cam_u = rng.stream_uniforms(k, 0, (4, local),
                                            lane_offset=lane_ids)
                origin, direction = generate_rays(
                    cam.position, cam.direction, cam.fov_scale,
                    cam.focal_depth, cam.aperture, resolution, cam_u,
                    pixel_idx=pixel_idx)
                r, stats = trace_paths(scene, cfg, meta, origin, direction, k,
                                       lane_offset=lane_ids,
                                       return_stats=True)
                acc = acc + torch.stack([r.x, r.y, r.z])
                rays = rays + stats.rays
            out.append(acc)
            shard_rays[s] = rays
        _wait(mesh)
        if mesh.group is not None:
            dist.all_reduce(shard_rays, group=mesh.group)
        return out, count + cfg.batch_spp, shard_rays

    step.pixel_order = lanes.pixel_order
    step.columns = lanes.columns
    return step


# ---------------------------------------------------------------------------
# differentiable train step (inverse rendering) with gradient all-reduce
# ---------------------------------------------------------------------------

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


def make_train_step(cfg: RenderConfig, meta, device: Optional[str] = None,
                    mesh: Optional[Mesh] = None):
    """Returns train_step(params, cam_params, scene, cam, target, base_key,
    step_idx) -> (loss, grads, cam_grads).

    Without a mesh the step runs on `device` ("cuda" by default; raises
    when no card is present) and target is the (3, N) image in
    `step.pixel_order` (column j is pixel pixel_order[j]).  With a mesh
    (`device` is then the mesh's), target is this process's columns
    (shard_accum), each shard takes the mean of its own squared error over
    its lanes and its gradient, and loss and gradients are averaged over
    the shards as JAX's pmean is: a mean of shard means, summed over the
    shards held here, all-reduced over the group, divided by the mesh
    size.  A one-shard mesh gives the mesh-less step's numbers bit for bit.

    params: split_params-shaped dict of leaf tensors that require grad
    (params_to_torch); cam_params: {"position", "direction"} likewise;
    scene: the port's SceneArrays and cam: a CameraState
    (runtime/renderer.py), all on the step's device; base_key: host key data (core/rng.py).  The
    sample is keyed sample_key(base_key, step_idx), as in the JAX step.
    Returns the loss as a 0-d tensor and the gradients shaped like params
    and cam_params (zeros where the loss does not depend on a leaf).  On a card the step waits for its kernels and
    raises if a traversal stack overflowed (ops/traverse.py
    check_stack_overflow).

    The returned function carries `.pixel_order`, `.columns` (the slice of
    it this process owns) and `.render(params, cam_params, scene, cam,
    base_key, step_idx)`, the forward alone, shaped like target."""
    check_config(cfg)
    whole = mesh is None
    if whole:
        mesh = Mesh(size=1, shards=(0,), group=None,
                    device=_device("cuda" if device is None else device))
    lanes = _Lanes(mesh, cfg)
    local = lanes.local
    resolution = (cfg.width, cfg.height)

    def radiance(j, params, cam_params, scene, cam, key):
        sc, c = merge_params(scene, params, cam, cam_params)
        cam_u = rng.stream_uniforms(key, 0, (4, local),
                                    lane_offset=lanes.lane_ids[j])
        origin, direction = generate_rays(
            c.position, c.direction, c.fov_scale, c.focal_depth, c.aperture,
            resolution, cam_u, pixel_idx=lanes.pixel_idx[j])
        r = trace_paths(sc, cfg, meta, origin, direction, key,
                        lane_offset=lanes.lane_ids[j])
        return torch.stack([r.x, r.y, r.z])

    def step(params, cam_params, scene, cam, target, base_key, step_idx):
        leaves = _flat(params) + _flat(cam_params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("train_step: every parameter must be a tensor "
                             "that requires grad (see params_to_torch)")
        targets = [target] if whole else target
        key = rng.sample_key(base_key, step_idx)
        losses, grads = [], []
        for j in range(len(mesh.shards)):
            # one shard's graph at a time: autograd.grad frees it
            with span("train.forward"), torch.enable_grad():
                loss = torch.mean((radiance(j, params, cam_params, scene,
                                            cam, key) - targets[j]) ** 2)
            with span("train.backward"):
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
            losses.append(loss.detach())
            grads.append([torch.zeros_like(p) if gi is None else gi
                          for p, gi in zip(leaves, g)])
        _wait(mesh)
        loss = _tree_sum(losses)
        grads = [_tree_sum(list(gs)) for gs in zip(*grads)]
        if mesh.group is not None:
            flat = torch.cat([loss.reshape(1)]
                             + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=mesh.group)
            parts = flat.split([1] + [g.numel() for g in grads])
            loss = parts[0].reshape(())
            grads = [p.reshape(g.shape) for p, g in zip(parts[1:], grads)]
        loss = loss / mesh.size
        grads = [g / mesh.size for g in grads]
        k = len(_flat(params))
        return (loss, _unflat(params, grads[:k]),
                _unflat(cam_params, grads[k:]))

    @torch.no_grad()
    def render(params, cam_params, scene, cam, base_key, step_idx):
        """The step's forward alone: its sample's radiance in pixel_order,
        shaped like target (a target rendered with it makes the loss 0 at
        those parameters, the same key and step_idx)."""
        key = rng.sample_key(base_key, step_idx)
        out = [radiance(j, params, cam_params, scene, cam, key)
               for j in range(len(mesh.shards))]
        _wait(mesh)
        return out[0] if whole else out

    step.pixel_order = lanes.pixel_order
    step.columns = lanes.columns
    step.render = render
    return step
