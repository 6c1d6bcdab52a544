"""The control of a cell's comparison: the plain reference put in the
program's place and computed in bfloat16 (reference/render.py `lowp`: the
path state stored in bfloat16 after every stage), compared with the
float32 reference by the cell's own numbers.  A comparison that does not
reject it cannot tell a lower-precision program from a sound one.

    python3 -m fsptbench.control --workload <cell> --seed <n> [--seed ...]

One JSON line a seed on standard output: the control's numbers and the
cell's limits.  It runs at the cell's own size, on the card (the tests
call run_control(..., device="cpu") on a small manifest).  The program
is not run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run_control(workload: str, seed: int, device: str = "cuda",
                manifest=None) -> dict:
    from fsptbench import checks
    from fsptbench.drive import reference_train, train_numbers
    from fsptbench.manifest import Manifest
    from fsptbench.reference.render import Reference, config
    from fsptbench.reference.scene import compile_scene
    from fsptbench.reference.tonemap import frame
    from fsptbench.scenegen import Assets
    m = manifest or Manifest(parked=True)
    cell = m.cell(workload)
    c = m.config(cell["config"])
    mix = m.traffic(cell["traffic"])
    r = config(c["render"], seed)
    assets = Assets(c["assets"], m.bench)
    if mix["kind"] == "train":
        low = reference_train(c["scene"], assets, r, mix, device, lowp=True)
        ref = reference_train(c["scene"], assets, r, mix, device)
        numbers = train_numbers(*low, *ref, mix["lr"])
    else:
        scene = compile_scene(c["scene"], assets, device)
        ref, low = Reference(scene, r), Reference(scene, r, lowp=True)
        if mix["kind"] == "progressive":
            idx = int(np.random.default_rng(seed).integers(
                mix["warmup_steps"], 64))
            args = (scene.camera, (r["width"], r["height"]), seed, idx,
                    r["batch_spp"])
            numbers = checks.radiance_numbers(low.step(*args).cpu().numpy(),
                                              ref.step(*args).cpu().numpy())
        else:
            w = max(int(r["width"] * 0.25) // 8 * 8, 16)
            h = max(int(r["height"] * 0.25) // 8 * 8, 16)
            post = {"exposure": c["scene"].get("exposure", 1.0),
                    "saturation": 1.0, "gamma": 2.2}
            args = (scene.camera, (w, h), seed, 0, 1)
            numbers = checks.frame_numbers(
                frame(low.step(*args), w, h, post),
                frame(ref.step(*args), w, h, post))
    return {"workload": workload, "seed": seed, "control": numbers,
            "limits": {k: v["limit"] for k, v in
                       m.limits(workload)["numbers"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m fsptbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fsptbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seed:
        print(json.dumps(run_control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
