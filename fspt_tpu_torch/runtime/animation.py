"""Frame-sequence (animation) batch rendering (port of
fspt_tpu.runtime.animation).

A resumable loop: each frame renders to `frame_%05d.png`, already-present
frames are skipped on restart, and an in-progress frame checkpoints its
accumulation every `checkpoint_every` batches so preemption resumes
mid-frame.

Animation semantics: entries in the scene's `animated_props` may carry a
`keyframes` list of `{"frame": F, "translate": [...], "rotate": [...],
"scale": s}`; values are linearly interpolated per frame before scene
compilation.  `_lerp`, `interpolate_keyframes` and `scene_for_frame` are
copies of the JAX package's (the tests hold them to the originals);
`render_animation` renders on one torch device.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Optional


def _lerp(a, b, t):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a + (b - a) * t
    return [x + (y - x) * t for x, y in zip(a, b)]


def interpolate_keyframes(prop: dict, frame: int) -> dict:
    """Resolve a prop's `keyframes` into concrete transform fields."""
    keys = prop.get("keyframes")
    if not keys:
        return prop
    keys = sorted(keys, key=lambda k: k["frame"])
    out = dict(prop)
    out.pop("keyframes", None)
    prev = keys[0]
    nxt = keys[-1]
    for k in keys:
        if k["frame"] <= frame:
            prev = k
        if k["frame"] >= frame:
            nxt = k
            break
    span = max(nxt["frame"] - prev["frame"], 1)
    t = min(max((frame - prev["frame"]) / span, 0.0), 1.0)
    for field in ("translate", "scale"):
        if field in prev or field in nxt:
            a = prev.get(field, out.get(field, 0.0 if field == "scale" else
                                        [0.0, 0.0, 0.0]))
            b = nxt.get(field, a)
            out[field] = _lerp(a, b, t)
    if "rotate" in prev or "rotate" in nxt:
        ra = prev.get("rotate", out.get("rotate", []))
        rb = nxt.get("rotate", ra)
        rot = []
        for i in range(max(len(ra), len(rb))):
            ka = ra[i] if i < len(ra) else rb[i]
            kb = rb[i] if i < len(rb) else ra[i]
            rot.append({"axis": ka.get("axis", kb.get("axis")),
                        "angle": _lerp(ka.get("angle", 0.0),
                                       kb.get("angle", 0.0), t)})
        out["rotate"] = rot
    return out


def scene_for_frame(scene_dict: dict, frame: int) -> dict:
    """Apply per-frame keyframe interpolation to animated props."""
    out = copy.deepcopy(scene_dict)
    animated = out.get("animated_props")
    if isinstance(animated, dict):
        for name, prop in animated.items():
            animated[name] = interpolate_keyframes(prop, frame)
    elif isinstance(animated, list):
        out["animated_props"] = [interpolate_keyframes(p, frame)
                                 for p in animated]
    return out


def render_animation(scene_dict: dict, loader, out_dir: str, frames: range,
                     config=None, samples: Optional[int] = None,
                     checkpoint_every: int = 32,
                     on_frame: Optional[Callable] = None,
                     name: str = "scene", refit: bool = False,
                     device="cuda") -> list:
    """Render a frame sequence with per-frame resume.  Returns paths.

    refit=True: keyframe animation is transform-only (keyframes carry only
    translate/rotate/scale), so instead of re-parsing and re-building the
    SAH BVH on the host every frame, the base frame is compiled ONCE and
    each frame's geometry + BVH boxes are rewritten on the device from the
    base frame's tables (scene/refit.py), under one Renderer.  Scenes the
    refit cannot express (`normalize`) take the rebuild path, as in the
    reference.  `device`: "cuda" by default, which raises without a card.
    """
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.runtime.renderer import Renderer, _device
    from fspt_tpu_torch.scene.schema import (_prop_defaults, load_scene_dict,
                                             merge_scene_props)

    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg = config or RenderConfig()
    paths = []

    refit_ctx = None
    if refit:
        from fspt_tpu_torch.scene.refit import (aux_to, build_refit_aux,
                                                delta_affines, refit_arrays)
        base_frame = frames[0] if len(frames) else 0
        base_sd = scene_for_frame(scene_dict, base_frame)
        base_scene = load_scene_dict(base_sd, loader, name=f"{name}_base")
        try:
            aux = build_refit_aux(base_scene)
        except ValueError:
            refit = False
        else:
            base_props = [_prop_defaults(p)
                          for p in merge_scene_props(base_sd)]
            wt = scene_dict.get("worldTransforms")
            renderer = Renderer(base_scene, cfg, device=device)
            refit_ctx = (base_scene, base_props, wt, renderer,
                         renderer.arrays, aux_to(aux, device))

    for frame in frames:
        out_path = os.path.join(out_dir, f"frame_{frame:05d}.png")
        paths.append(out_path)
        if os.path.exists(out_path):
            continue
        sd = scene_for_frame(scene_dict, frame)
        if refit_ctx is not None:
            base_scene, base_props, wt, r, base_arrays, aux = refit_ctx
            fprops = [_prop_defaults(p) for p in merge_scene_props(sd)]
            mats, trans = delta_affines(base_props, fprops, wt)
            r.arrays = refit_arrays(base_arrays, base_scene.meta, aux, mats,
                                    trans)
            r.reset()
            scene = base_scene
        else:
            scene = load_scene_dict(sd, loader, name=f"{name}_f{frame}")
            r = Renderer(scene, cfg, device=device)
        ckpt = os.path.join(out_dir, f"frame_{frame:05d}.ckpt.npz")
        if os.path.exists(ckpt):
            r.load_checkpoint(ckpt)
        target = samples if samples is not None else scene.samples
        while float(r.count) < target:
            r.step(min(checkpoint_every,
                       max(1, int(target - float(r.count)))))
            r.save_checkpoint(ckpt)
        r.save(out_path)
        os.remove(ckpt)
        if on_frame is not None:
            on_frame(frame, out_path, r)
    return paths
