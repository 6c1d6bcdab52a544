"""Whole runs on the CPU at a small size: a sound run is correct; a run
with the timed path broken underneath is not; the bfloat16 control is
rejected by every cell's comparison.  The look for a card is skipped
(run_cell on "cpu"): the program's plain kernels stand in for its CUDA
ones."""

import dataclasses

import pytest
import torch

from fsptbench.control import run_control
from fsptbench.run import run_cell

# the cells of BENCHMARK.json and the parked viewer cell
CELLS = ("bunny8_main.progressive", "bunny4_cli.progressive",
         "bunny4_cli.interactive", "bunny8_main.train")
SEED = 3_123_456_789


def _unchanged(mp):
    """A step that returns its state unchanged: the render adds nothing to
    the accumulation; the train step hands back zero gradients."""
    from fspt_tpu_torch.parallel import dist
    from fspt_tpu_torch.runtime import renderer

    def step(scene, cfg, meta, cam, accum, count, rays, *a):
        return accum, count + cfg.batch_spp, rays
    mp.setattr(renderer, "sample_step", step)
    make = dist.make_train_step

    def make_train_step(*a, **kw):
        fn = make(*a, **kw)

        def train_step(*b):
            loss, grads, cam = fn(*b)
            zero = {k: type(v)(*(torch.zeros_like(x) for x in v))
                    if isinstance(v, tuple) else torch.zeros_like(v)
                    for k, v in grads.items()}
            return loss, zero, cam
        train_step.render = fn.render
        return train_step
    mp.setattr(dist, "make_train_step", make_train_step)


def _half_batch(mp):
    """Half of the batch left out, the mean taken over the rest: a step of
    half its samples counted twice; a one-sample step (a preview, a train
    sample) whose second half of lanes is left out and the first half
    counted twice."""
    from fspt_tpu_torch.parallel import dist
    from fspt_tpu_torch.runtime import renderer
    orig = renderer.sample_step

    def step(scene, cfg, meta, cam, accum, count, rays, *a):
        half = dataclasses.replace(cfg, batch_spp=max(cfg.batch_spp // 2, 1))
        acc, _, rays = orig(scene, half, meta, cam, accum, count, rays, *a)
        return (accum + (acc - accum) * (cfg.batch_spp / half.batch_spp),
                count + cfg.batch_spp, rays)
    trace = dist.trace_paths

    def trace_paths(*a, **kw):
        out = trace(*a, **kw)
        stats = kw.get("return_stats", False)
        r = out[0] if stats else out
        n = r.x.shape[0]
        keep = (torch.arange(n, device=r.x.device) < n // 2).float() * 2.0
        r = type(r)(*(c * keep for c in r))
        return (r, out[1]) if stats else r

    def one_sample_step(scene, cfg, meta, cam, accum, count, rays, *a):
        if cfg.batch_spp > 1:
            return step(scene, cfg, meta, cam, accum, count, rays, *a)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(renderer, "trace_paths", trace_paths)
            return orig(scene, cfg, meta, cam, accum, count, rays, *a)
    mp.setattr(renderer, "sample_step", one_sample_step)
    mp.setattr(dist, "trace_paths", trace_paths)


def _altered_hits(mp):
    from fspt_tpu_torch.core import integrator
    orig = integrator.packet_traverse4

    def traverse(*a, **kw):
        hit = orig(*a, **kw)
        slot = hit.slot.clone()
        slot[::64] = -1
        return hit._replace(slot=slot)
    mp.setattr(integrator, "packet_traverse4", traverse)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small, cell):
    r = run_cell(cell, SEED, 1.0, False, "cpu", small)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(small.limits(cell)["numbers"])
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_hits],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(small, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell(cell, SEED, 1.0, False, "cpu", small)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_rejected(small, cell):
    out = run_control(cell, SEED, "cpu", small)
    assert any(out["control"][k] > out["limits"][k] for k in out["limits"])
