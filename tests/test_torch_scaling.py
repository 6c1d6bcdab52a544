"""The port's scaling meter (fspt_tpu_torch.parallel.scaling): the two
tests of tests/test_scaling.py on meshes held by one CPU process.  The
shards of one process run one after another, so wall-clock scaling is not
asserted; the load-balance efficiency is exact on any mesh and is."""

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.parallel.scaling import measure_scaling
from fspt_tpu_torch.runtime.renderer import Renderer
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)

CFG = dict(width=16, height=16, bounces=2, extra_refraction_iters=1,
           batch_spp=1, seed=0)


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdivisions=2)


def test_scaling_efficiency_meets_target(scene):
    report = measure_scaling(scene, RenderConfig(**CFG),
                             device_counts=(1, 2, 4, 8), steps=1, warmup=1,
                             device="cpu")
    assert [p.n_devices for p in report.points] == [1, 2, 4, 8]
    # 1 shard is trivially balanced
    assert report.points[0].balance_efficiency == 1.0
    # ray accounting must be mesh-invariant: same total honest rays
    totals = [p.rays for p in report.points]
    np.testing.assert_allclose(totals, totals[0], rtol=1e-6)
    # the acceptance target, measured on the 8-way mesh
    assert report.efficiency >= 0.85, report.table()
    assert len(report.table().splitlines()) == 5


def test_shard_ray_counts_match_single_device(scene):
    """The per-shard ray counts sum to the single-device renderer's honest
    count: the meter measures the same work."""
    cfg = RenderConfig(**CFG)
    report = measure_scaling(scene, cfg, device_counts=(8,), steps=1,
                             warmup=0, device="cpu")
    r = Renderer(scene, cfg, device="cpu")
    r.step()
    np.testing.assert_allclose(report.points[0].rays * 1,  # 1 step
                               r.stats["rays"], rtol=1e-6)


def test_measure_scaling_defaults_to_cuda(scene, monkeypatch):
    """No card: the meter raises rather than measure the CPU; a mesh size
    that does not divide the pixel count is skipped."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_scaling(scene, RenderConfig(**CFG), device_counts=(1,))
    report = measure_scaling(scene, RenderConfig(**CFG), device_counts=(3,),
                             steps=1, warmup=0, device="cpu")
    assert report.points == []
