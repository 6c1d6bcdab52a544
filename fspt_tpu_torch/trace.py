"""Spans of the program's phases, on torch.profiler's clock.

`with span("shade"): ...` marks one phase.  While a profiler records, the
span is `torch.profiler.record_function("fspt.shade")`: it lands in the
profiler's trace beside the host's ops and the kernels they launch, so a
Chrome trace of `Renderer.profile_trace` (or any profiler the caller runs)
names the phase every op and kernel belongs to.  With no profiler
recording, a span costs one flag check and creates no RecordFunction.
Whether a span records is decided when it is entered and kept until it
exits.

The spans, each where its work happens:

  fspt.step           runtime/renderer.py Renderer.step, its whole body
  fspt.replay         runtime/renderer.py StepGraph.replay: one launch of
                      a captured sample batch (on a card, every batch after
                      a Renderer's first); the phases below then run on
                      the device alone and show no span
  fspt.traverse       core/integrator.py intersect (and the heatmap's
                      launch, and Renderer.autofocus's walk): one a launch
  fspt.raysort        core/integrator.py sorted_intersect, where it sorts
                      (sort_rays without sort_state, as the exact-replay
                      estimator runs): the key, the sort, the row gather,
                      the launch's fspt.traverse and the un-permute
  fspt.tables         core/integrator.py scene_tables: the material, env
                      and attribute tables, built in trace_paths and
                      trace_paths_batched where the caller passed none,
                      and by runtime/renderer.py StepGraph once a capture
                      or scene refresh
  fspt.shade          core/integrator.py _bounce: _shade_and_scatter
  fspt.atlas          _shade_and_scatter: the material maps' fetch
  fspt.light          _shade_and_scatter, with light NEE: two a bounce,
                      the light's pick, point and shadow segment before
                      the traversal launch, its MIS-weighted add after
  fspt.uniforms       _bounce: the iteration's stream_uniforms
  fspt.sort           _sort_state
  fspt.compact        _compact
  fspt.train.forward  parallel/dist.py make_train_step: a shard's
                      radiance and loss
  fspt.train.backward the same step: a shard's torch.autograd.grad
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

PREFIX = "fspt."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over one phase named PREFIX + name."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _OFF
