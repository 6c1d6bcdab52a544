"""v5 mixed-substep kernel A/B against the v4 phase-split kernel on the
real captured bounce-0 launch (port of scripts/perf_r5i.py; see
traverse5_proto.py for the design).

The baseline is the port's `packet_traverse4` (ops/traverse4.py, one ray
per thread), whose `visits` count per RAY; v5's count per 128-ray WALK.
The two are printed under their own names and never compared.  Hits are
compared: slot_match and t_close against v4 on every lane.

Run on the card: python -m fspt_tpu_torch.scripts.perf_r5i
"""

from __future__ import annotations

import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops.traverse import check_stack_overflow
from fspt_tpu_torch.ops.traverse4 import packet_traverse4
from fspt_tpu_torch.scripts.r5common import capture_bounce0, drain, timed
from fspt_tpu_torch.scripts.traverse5_proto import packet_traverse5

SCHEDULE = (1.5, 11, 48, 160, 640, 2048, 2048, 2048)
SWEEP = (dict(npop=2, lpop=2, unroll=4, drain_unroll=4),
         dict(npop=2, lpop=2, unroll=6, drain_unroll=4),
         dict(npop=2, lpop=2, unroll=2, drain_unroll=4),
         dict(npop=2, lpop=1, unroll=4, drain_unroll=4),
         dict(npop=1, lpop=2, unroll=6, drain_unroll=4),
         dict(npop=2, lpop=3, unroll=4, drain_unroll=4),
         dict(npop=3, lpop=2, unroll=4, drain_unroll=4))


def bench_config() -> RenderConfig:
    return RenderConfig(width=512, height=512, bounces=8,
                        extra_refraction_iters=0, compact=True,
                        intersector="split", compact_schedule=SCHEDULE)


def main(scene=None):
    """The sweep on the card; returns {"t4": s, "sets": [(kw, s, visits
    per walk, slot_match, t_close)], "best": (s, kw), "go": bool}."""
    if not torch.cuda.is_available():
        raise SystemExit("perf_r5i: needs a CUDA device")
    from fspt_tpu_torch.testing import make_bunny_standin_scene
    dev = torch.device("cuda")
    scene = scene or make_bunny_standin_scene(subdivisions=6)
    arrays, meta = scene.to_torch(dev), scene.meta
    cfg = bench_config()
    print("capturing bounce-0 launch ...", flush=True)
    so, sd, stm, sa = capture_bounce0(scene, arrays, meta, cfg)
    print(f"launch lanes={so.x.shape[0]} active={int(sa.sum())}", flush=True)

    nodes, leaves = arrays.pk_nodes, arrays.pk_leaves
    sdep = meta.pk_stack_depth + 16

    def v4():
        return packet_traverse4(nodes, leaves, so, sd, stm,
                                leaf_size=meta.leaf_size, stack_depth=sdep)

    t4 = timed(v4, reps=5)
    ref = drain(v4())
    check_stack_overflow(dev)
    print(f"v4 (port, one ray per thread)  {t4 * 1e3:8.2f} ms  "
          f"visits/ray={ref.visits.float().mean().item():.1f}", flush=True)

    sets, best = [], None
    for kw in SWEEP:
        def v5(kw=kw):
            return packet_traverse5(nodes, leaves, so, sd, stm,
                                    leaf_size=meta.leaf_size,
                                    stack_depth=sdep, **kw)
        out = drain(v5())
        check_stack_overflow(dev)
        t5 = timed(v5, reps=5)
        vis5 = out.visits.reshape(-1, 128)[:, 0].float().mean().item()
        s_match = (out.slot == ref.slot).float().mean().item()
        t_close = torch.isclose(out.t, ref.t, rtol=1e-5,
                                atol=1e-5).float().mean().item()
        tag = " ".join(f"{k[0]}{v}" for k, v in kw.items())
        print(f"v5 {tag:<24s} {t5 * 1e3:8.2f} ms  visits/walk={vis5:.1f}  "
              f"slot_match={s_match:.6f} t_close={t_close:.6f}", flush=True)
        sets.append((kw, t5, vis5, s_match, t_close))
        if best is None or t5 < best[0]:
            best = (t5, kw)
    go = best[0] < t4 * 0.97
    print(f"\nbest v5 {best[1]} = {best[0] * 1e3:.2f} ms vs v4 "
          f"{t4 * 1e3:.2f} ms -> {'GO' if go else 'NO-GO'}", flush=True)
    return {"t4": t4, "sets": sets, "best": best, "go": go}


if __name__ == "__main__":
    main()
