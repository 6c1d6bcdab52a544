"""fspt_tpu_torch — the PyTorch + CUDA port of fspt_tpu for NVIDIA Hopper.

The same progressive Monte-Carlo path tracer as fspt_tpu (which stays the
JAX reference): the host scene compiler is a jax-free copy, the device code
is PyTorch, and BVH traversal is hand-written CUDA: csrc/traverse4.cu behind
ops/traverse4.py ("split"), csrc/walk.cu behind ops/traverse3.py ("walk",
the heatmap) and csrc/walk1.cu behind ops/traverse.py ("packet"); so is the
integrator's PCG4D, csrc/pcg4d.cu behind ops/pcg4d.py.  Nothing here
imports JAX.  `python -m fspt_tpu_torch` is the command line.

Public API:
    fspt_tpu_torch.load_scene_dict(d, loader) / load_scene_file(path)
    fspt_tpu_torch.Renderer(scene, config, device="cuda")
    fspt_tpu_torch.render(scene, config, device="cuda")
    fspt_tpu_torch.parallel.dist.make_train_step(config, meta, device="cuda",
                                                 mesh=None)
    fspt_tpu_torch.parallel.dist.make_mesh(num_devices, device="cuda") /
        make_sharded_sample_step(mesh, config, meta) / shard_accum /
        gather_accum
    fspt_tpu_torch.parallel.multihost.initialize() / global_mesh()
    fspt_tpu_torch.parallel.scaling.measure_scaling(scene, config)
"""

__version__ = "0.1.0"

from fspt_tpu_torch.config import CameraConfig, PostConfig, RenderConfig
from fspt_tpu_torch.runtime.renderer import Renderer, render
from fspt_tpu_torch.scene.schema import (Scene, load_scene_dict,
                                         load_scene_file, scene_to_torch)

__all__ = [
    "RenderConfig",
    "PostConfig",
    "CameraConfig",
    "load_scene_file",
    "load_scene_dict",
    "scene_to_torch",
    "Scene",
    "Renderer",
    "render",
]
