"""The port's multi-process path (fspt_tpu_torch.parallel.multihost): two
OS processes form a gloo process group on the CPU through
multihost.initialize, build the global mesh and run across it.  The
workers import torch and fspt_tpu_torch only, never JAX.

  * the psum smoke of tests/test_multihost.py:156-187: 2 processes x 2
    shards = a mesh of 4, a sum over it of 6.0;
  * the exactness check of tests/test_multihost.py:191-246: the 2-process,
    4-shard render with compaction and the state sort, gathered on every
    rank, equal bit for bit to the same process's single-device Renderer;
    and in the same worker the 2-process train step against a one-process
    mesh of the same size (rtol 1e-6).
"""

import os
import socket
import subprocess
import sys

_HEAD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from fspt_tpu_torch.parallel import multihost
port, pid = sys.argv[1], int(sys.argv[2])
"""

_TAIL = r"""
dist.destroy_process_group()
assert "jax" not in sys.modules
"""

_WORKER = _HEAD + r"""
from fspt_tpu_torch.parallel.dist import make_mesh
multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
assert dist.get_world_size() == 2, dist.get_world_size()
assert multihost.is_coordinator() == (pid == 0)
whole = multihost.global_mesh(device="cpu")
assert whole.size == 2 and whole.shards == (pid,), whole
mesh = make_mesh(4, device="cpu")
assert mesh.size == 4 and mesh.shards == (2 * pid, 2 * pid + 1), mesh
try:
    make_mesh(3, device="cpu")
except ValueError:
    pass
else:
    raise AssertionError("a mesh of 3 over 2 processes did not raise")
x = torch.arange(4, dtype=torch.float32)
total = sum(x[s] for s in mesh.shards).reshape(1)
dist.all_reduce(total, group=mesh.group)
np.testing.assert_allclose(total.numpy(), 6.0)
print(f"proc {pid} OK")
""" + _TAIL

_RENDER_WORKER = _HEAD + r"""
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.core import rng
from fspt_tpu_torch.parallel.dist import (gather_accum, make_mesh,
                                          make_sharded_sample_step,
                                          make_train_step, params_to_torch,
                                          shard_accum, split_params)
from fspt_tpu_torch.runtime.renderer import CameraState, Renderer
from fspt_tpu_torch.testing import make_test_scene

# the estimator's machinery at test scale: compact schedule, state-order
# coherence sort, deferred deposits (dist.py loops batch_spp per shard)
scene = make_test_scene()
cfg = RenderConfig(width=32, height=32, bounces=2,
                   extra_refraction_iters=1, batch_spp=1, seed=0,
                   compact=True, sort_state=True)
n = cfg.width * cfg.height
arrays = scene.to_torch("cpu")
cam = CameraState.from_config(scene.camera, "cpu")
target_all = torch.from_numpy(np.random.default_rng(5).uniform(
    0.0, 1.0, (3, n)).astype(np.float32))


def train(mesh):
    step = make_train_step(cfg, scene.meta, mesh=mesh)
    params = params_to_torch(
        {f: np.asarray(v) for f, v in split_params(scene.arrays).items()},
        "cpu")
    cam_params = params_to_torch({"position": scene.camera.position,
                                  "direction": scene.camera.direction}, "cpu")
    loss, grads, cam_grads = step(params, cam_params, arrays, cam,
                                  shard_accum(target_all, mesh), rng.key(1),
                                  0)
    return [loss] + [p for g in list(grads.values())
                     + list(cam_grads.values())
                     for p in (g if isinstance(g, tuple) else (g,))]


# the one-process mesh of the same size, made before the group exists
one_process = train(make_mesh(4, device="cpu"))

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
mesh = make_mesh(4, device="cpu")
assert mesh.size == 4 and mesh.group is not None
step = make_sharded_sample_step(mesh, cfg, scene.meta)
accum = shard_accum(torch.zeros((3, n)), mesh)
count = torch.zeros(())
for i in range(2):
    accum, count, shard_rays = step(arrays, cam, accum, count,
                                    rng.key(cfg.seed), i)
assert shard_rays.shape == (4,) and float(shard_rays.min()) > 0
sharded = gather_accum(accum, mesh).numpy() / float(count)

# single-device reference, computed locally in this same process
r = Renderer(scene, cfg, device="cpu").step(2)
single = r.accum.numpy() / 2.0
img_sharded = np.zeros((n, 3), np.float32)
img_sharded[step.pixel_order] = sharded.T
img_single = np.zeros((n, 3), np.float32)
img_single[r.pixel_idx.numpy()] = single.T
np.testing.assert_array_equal(img_sharded, img_single)

for a, b in zip(train(mesh), one_process):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0.0)
print(f"proc {pid} RENDER OK")
""" + _TAIL


def _run_two_procs(worker, timeout):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    portno = port.getsockname()[1]
    port.close()
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(__file__))]
                   + sys.path))
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(portno), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode())
    return procs, outs


def test_two_process_cpu_smoke():
    procs, outs = _run_two_procs(_WORKER, 120)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out


def test_two_process_render_per_pixel_exact():
    """Cross-process per-pixel exactness: the lane-id-keyed RNG makes the
    gathered 2-process image the single-device renderer's bit for bit, and
    the train step's pairwise shard sum continues in the all-reduce, so
    the 2-process step equals the one-process 4-shard step."""
    procs, outs = _run_two_procs(_RENDER_WORKER, 120)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} RENDER OK" in out
