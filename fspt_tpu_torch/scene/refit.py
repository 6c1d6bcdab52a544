"""On-device BVH refit for transform-only animation (port of
fspt_tpu.scene.refit).

For keyframe animation the topology never changes, only per-prop affine
transforms, so the per-frame host rebuild (runtime/animation.py ->
load_scene_dict) collapses to a refit on the device:

  1. transform the padded per-slot triangle soup (and shading frames,
     light tris) by each prop's delta affine against the base frame;
  2. recompute leaf AABBs and sweep them up the (static) binary tree,
     one level at a time (depth-grouped gathers and index writes);
  3. rewrite the packed wide-node child boxes through the wide-child ->
     binary-node map recorded at pack time
     (ops/packing.PackedBVH.wide_child_bin) and re-emit the packed leaf
     triangle rows.

The refit tree keeps the base frame's topology with looser, overlapping
boxes, so the traversal kernels walk longer as the motion grows (the
standard refit trade-off); the tables keep their shapes, so a Renderer
takes them as they are.  Every refit starts from the base frame's tables,
which it never writes.

RefitAux, prop_affine, build_refit_aux and delta_affines are host NumPy,
copied from fspt_tpu.scene.refit with their import paths changed (the
tests hold the copies to the originals); refit_arrays is re-written in
torch and runs on the device of the arrays it is given.

On one NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 17, the
bench scene: 81,922 triangles, 28,275 binary nodes in 16 levels), a refit
takes 3.8-6.6 ms a frame (a process's first ~55 ms; 333 kernels, 0.78 ms
of device time), the host rebuild it replaces (load_scene_dict +
to_torch) 709-967 ms.

Delta affines are derived by probing the SAME host transform pipeline the
scene compiler uses (scene/transforms.apply_prop_transforms), so refit
frames match rebuild frames for rigid+uniform-scale animation (the only
kind the schema's keyframes express).  Scenes using `normalize` (global
recenter/rescale from per-frame bounds) are rejected: their frames are not
transform-only.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.ops.packing import BIG
from fspt_tpu_torch.scene.transforms import apply_prop_transforms


class RefitAux(NamedTuple):
    """Static (host-built, per-scene) structure for the on-device refit."""

    slot_prop: np.ndarray        # (S,) i32 prop id per padded slot (pad=0)
    slot_valid: np.ndarray       # (S,) bool — real triangle, not padding
    levels: Tuple[np.ndarray, ...]   # internal binary ids, deepest first
    leaf_ids: np.ndarray         # (L,) i32 binary ids of leaf nodes
    leaf_ord: np.ndarray         # (L,) i32 leaf ordinal (tri_offset/leaf)
    wide_child_bin: np.ndarray   # (Wn, width) i32 (-1 empty)
    width: int
    leaf_size: int
    base_affine: np.ndarray      # (P, 3, 4) f64 base-frame prop affines


def prop_affine(prop: dict, world_transforms=None) -> np.ndarray:
    """(3, 4) affine [M | t] of a prop's transform chain, derived by
    probing the scene compiler's own pipeline so refit and rebuild agree
    bit-for-bit on the math."""
    probe = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                      [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    out = apply_prop_transforms(probe, prop.get("rotate", []),
                                prop.get("scale", 1.0),
                                prop.get("translate", [0.0, 0.0, 0.0]),
                                world_transforms)
    t = out[0]
    M = (out[1:] - t).T                      # columns = images of e_i
    return np.concatenate([M, t[:, None]], axis=1)


def build_refit_aux(scene) -> RefitAux:
    """Derive the static refit structure from a compiled Scene."""
    if scene.build is None:
        raise ValueError("scene has no build products (constructed "
                         "outside load_scene_dict); refit unavailable")
    if scene.build["normalized"]:
        raise ValueError("scenes with `normalize` recenter/rescale from "
                         "per-frame bounds; frames are not transform-only "
                         "— use the full rebuild path")
    a = scene.arrays
    slot_tri = scene.build["slot_tri"]
    tri_prop = scene.build["tri_prop"]
    valid = slot_tri >= 0
    slot_prop = np.where(valid, tri_prop[np.maximum(slot_tri, 0)],
                         0).astype(np.int32)

    left = np.asarray(a.node_left)
    right = np.asarray(a.node_right)
    tri = np.asarray(a.node_tri)
    n = len(left)
    depth = np.zeros(n, np.int32)
    order = [0]
    for i in order:                          # BFS (preorder ids)
        if tri[i] < 0:
            depth[left[i]] = depth[i] + 1
            depth[right[i]] = depth[i] + 1
            order.append(int(left[i]))
            order.append(int(right[i]))
    internal = np.nonzero(tri < 0)[0]
    levels = tuple(
        internal[depth[internal] == d].astype(np.int32)
        for d in range(int(depth.max()) if n > 1 else 0, -1, -1)
        if np.any(depth[internal] == d))
    leaf_ids = np.nonzero(tri >= 0)[0].astype(np.int32)
    leaf_ord = (tri[leaf_ids] // scene.leaf_size).astype(np.int32)
    return RefitAux(
        slot_prop=slot_prop, slot_valid=valid, levels=levels,
        leaf_ids=leaf_ids, leaf_ord=leaf_ord,
        wide_child_bin=scene.build["wide_child_bin"],
        width=scene.meta.bvh_width, leaf_size=scene.leaf_size,
        base_affine=np.zeros((scene.build["n_props"], 3, 4)))


def delta_affines(base_props, frame_props, world_transforms=None):
    """(P, 3, 3) matrices + (P, 3) translations mapping base-frame
    geometry to frame geometry: D = A_f o A_base^{-1}."""
    mats, trans = [], []
    for pb, pf in zip(base_props, frame_props):
        Ab = prop_affine(pb, world_transforms)
        Af = prop_affine(pf, world_transforms)
        Mb, tb = Ab[:, :3], Ab[:, 3]
        Mf, tf = Af[:, :3], Af[:, 3]
        D = Mf @ np.linalg.inv(Mb)
        mats.append(D)
        trans.append(tf - D @ tb)
    return (np.asarray(mats, np.float32), np.asarray(trans, np.float32))


def aux_to(aux: RefitAux, device) -> RefitAux:
    """`aux` with its index arrays as int64 tensors on `device` (a no-op for
    those already there).  Convert once per scene: refit_arrays then copies
    nothing from the host but the frame's affines."""
    dev = torch.device(device)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    return aux._replace(
        slot_prop=idx(aux.slot_prop),
        slot_valid=torch.as_tensor(aux.slot_valid, device=dev),
        levels=tuple(idx(ids) for ids in aux.levels),
        leaf_ids=idx(aux.leaf_ids), leaf_ord=idx(aux.leaf_ord),
        wide_child_bin=idx(aux.wide_child_bin))


def _mv(M, p):
    """(S, 3, 3) @ (S, 3) -> (S, 3), as three products and two sums."""
    return (M[:, :, 0] * p[:, None, 0] + M[:, :, 1] * p[:, None, 1]
            + M[:, :, 2] * p[:, None, 2])


def refit_arrays(arrays, meta, aux: RefitAux, mats, trans):
    """New SceneArrays with transformed geometry + refit BVH.

    arrays: base-frame SceneArrays (tensors on one device); mats (P, 3, 3) /
    trans (P, 3) delta affines, NumPy or tensors.  Returns
    arrays._replace(...) with identical shapes and dtypes; `arrays` is not
    written.  Nothing is read back to the host: the light count stays a
    0-d tensor in the mask.
    """
    dev = arrays.pk_nodes.device
    aux = aux_to(aux, dev)
    mats = torch.as_tensor(mats, dtype=torch.float32, device=dev)
    trans = torch.as_tensor(trans, dtype=torch.float32, device=dev)
    pid = aux.slot_prop
    keep = aux.slot_valid[:, None]
    M = mats[pid]                                    # (S, 3, 3)
    T = trans[pid]                                   # (S, 3)

    v0 = torch.where(keep, _mv(M, arrays.tri_v0) + T, 0.0)
    e1 = torch.where(keep, _mv(M, arrays.tri_e1), 0.0)
    e2 = torch.where(keep, _mv(M, arrays.tri_e2), 0.0)

    def xf_frame(v3: V3) -> V3:
        # shading-frame vectors rotate with the prop; lengths are NOT
        # renormalized — corner normals are stored area-weighted (smooth
        # mode) and the shader normalizes after barycentric mixing, so a
        # uniform scale factor cancels.  (Keyframes express rigid +
        # uniform-scale motion only, where M^-T is proportional to M.)
        out = torch.where(keep, _mv(M, torch.stack(tuple(v3), -1)), 0.0)
        return V3(out[:, 0], out[:, 1], out[:, 2])

    # ---- leaf AABBs -> binary-tree upward sweep ------------------------
    p1 = v0 + e1
    p2 = v0 + e2
    inf = float(BIG)
    tmin = torch.where(keep, torch.minimum(torch.minimum(v0, p1), p2), inf)
    tmax = torch.where(keep, torch.maximum(torch.maximum(v0, p1), p2), -inf)
    L = aux.leaf_ord.shape[0]
    ls = aux.leaf_size
    lmin = tmin.reshape(L, ls, 3).amin(1)            # slots are leaf-ordered
    lmax = tmax.reshape(L, ls, 3).amax(1)

    # the base frame's boxes stay as they are: the writes go to copies
    node_min = arrays.node_min.clone()
    node_max = arrays.node_max.clone()
    node_min[aux.leaf_ids] = lmin[aux.leaf_ord]
    node_max[aux.leaf_ids] = lmax[aux.leaf_ord]
    left = arrays.node_left.long()
    right = arrays.node_right.long()
    for ids in aux.levels:                           # deepest level first
        li, ri = left[ids], right[ids]
        node_min[ids] = torch.minimum(node_min[li], node_min[ri])
        node_max[ids] = torch.maximum(node_max[li], node_max[ri])

    # ---- rewrite packed tables -----------------------------------------
    w = aux.width
    cvalid = aux.wide_child_bin >= 0                 # (Wn, w)
    sub = aux.wide_child_bin.clamp(min=0)
    cmin = node_min[sub]                             # (Wn, w, 3)
    cmax = node_max[sub]
    cols = ([torch.where(cvalid, cmin[:, :, k], inf) for k in range(3)]
            + [torch.where(cvalid, cmax[:, :, k], -inf) for k in range(3)])
    pk_nodes = torch.cat(cols + [arrays.pk_nodes[:, 6 * w:]], 1)

    tri9 = torch.cat([v0, e1, e2], -1).reshape(L, ls * 9)
    pk_leaves = torch.cat([tri9, arrays.pk_leaves[:, ls * 9:]], 1)

    # ---- lights (areas/cdf change under scaling) -----------------------
    lpid = pid[arrays.light_slot.long()]
    Ml = mats[lpid]
    Tl = trans[lpid]
    n_lt = arrays.light_slot.shape[0]
    lmask = (torch.arange(n_lt, device=dev) < arrays.n_light_tris)[:, None]

    def lv(v3: V3, pts: bool):
        v = torch.stack(tuple(v3), -1)
        out = _mv(Ml, v) + (Tl if pts else 0.0)
        return torch.where(lmask, out, v)
    nl_v0 = lv(arrays.light_v0, True)
    nl_e1 = lv(arrays.light_e1, False)
    nl_e2 = lv(arrays.light_e2, False)
    areas = 0.5 * torch.linalg.vector_norm(
        torch.linalg.cross(nl_e1, nl_e2), dim=-1)
    areas = torch.where(lmask[:, 0], areas, 0.0)
    total = areas.sum()
    cdf = torch.cumsum(areas, 0) / torch.clamp(total, min=1e-20)

    as3 = lambda a: V3(a[:, 0], a[:, 1], a[:, 2])
    return arrays._replace(
        pk_nodes=pk_nodes, pk_leaves=pk_leaves,
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        node_min=node_min, node_max=node_max,
        nrm0=xf_frame(arrays.nrm0), nrm1=xf_frame(arrays.nrm1),
        nrm2=xf_frame(arrays.nrm2),
        tan0=xf_frame(arrays.tan0), tan1=xf_frame(arrays.tan1),
        tan2=xf_frame(arrays.tan2),
        btn0=xf_frame(arrays.btn0), btn1=xf_frame(arrays.btn1),
        btn2=xf_frame(arrays.btn2),
        light_v0=as3(nl_v0), light_e1=as3(nl_e1), light_e2=as3(nl_e2),
        light_cdf=cdf, light_area=total,
    )
