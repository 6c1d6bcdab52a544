"""Wavefront OBJ mesh parser -> vectorized triangle soup (NumPy).

Behavioral parity with reference obj_loader.js:6-215:
  * v/vt/vn/f/usemtl/mtllib statements; fan triangulation of n-gons
    (obj_loader.js:54-60); negative/zero index wrap for vertex and normal
    indices (obj_loader.js:103-116).
  * per-prop model transforms rotate -> scale -> translate plus optional scene
    worldTransforms (obj_loader.js:24-38).
  * normal modes: "mesh" (use file vn, rotation-only transform), "smooth"
    (mesh-wide average of incident flat face normals per vertex index,
    obj_loader.js:46-52,196-203), default flat (obj_loader.js:150-159).
  * spherical UV generation when a face has no vt (obj_loader.js:63-69) and
    per-corner tangent/bitangent frames Gram-Schmidt-orthogonalized against
    the shading normal (obj_loader.js:78-100).
  * `skips`: group names whose faces are dropped (obj_loader.js:15,170).

Unlike the reference (per-triangle JS objects), everything is stored as flat
(T, 3, 3)/(T, 3, 2) arrays grouped by material — the layout the device side
consumes directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from fspt_tpu_torch.scene.transforms import apply_prop_transforms, normalize

DEFAULT_GROUP = "FSPT_DEFAULT_GROUP"


@dataclasses.dataclass
class MeshGroup:
    """One usemtl group: a vectorized triangle soup."""

    name: str
    verts: np.ndarray          # (T, 3, 3) float64, transformed positions
    normals: np.ndarray        # (T, 3, 3) shading normals (may be non-unit for "smooth")
    uvs: np.ndarray            # (T, 3, 2)
    tangents: np.ndarray       # (T, 3, 3)
    bitangents: np.ndarray     # (T, 3, 3)
    material: Dict             # resolved MTL material dict (may be empty)


@dataclasses.dataclass
class ParsedMesh:
    groups: List[MeshGroup]
    bounds_min: np.ndarray     # (3,)
    bounds_max: np.ndarray     # (3,)
    mtllib: Optional[str]      # path of the referenced .mtl, if any


def _wrap_index(idx: int, count: int) -> int:
    """OBJ 1-based; <1 means relative-from-end (obj_loader.js:108,113)."""
    return count + idx + 1 if idx < 1 else idx


def _parse_faces(bodies: List[str]) -> np.ndarray:
    """Face-line bodies -> (T, 3 corners, 3 fields[v,t,n]) int64 triangles.

    Fast path (one NumPy parse) when every face is a triangle with a uniform
    corner format (v, v/t, v/t/n, or v//n); anything else — n-gons needing
    fan triangulation, mixed formats — takes the general per-token loop."""
    blob = " ".join(bodies)
    specs_n = len(blob.split())
    if specs_n == 3 * len(bodies):
        has_hole = "//" in blob
        probe = blob.replace("//", "/0/") if has_hole else blob
        first = probe.split(None, 1)[0] if probe else ""
        c = first.count("/")
        if c <= 2 and probe.count("/") == c * specs_n:
            flat = np.array(probe.replace("/", " ").split(), np.float64)
            if len(flat) == specs_n * (c + 1):   # no empty fields anywhere
                tri = flat.astype(np.int64).reshape(-1, 3, c + 1)
                out = np.zeros((len(tri), 3, 3), np.int64)
                out[:, :, : c + 1] = tri
                return out

    faces = []
    for body in bodies:
        corners = []
        for spec in body.split():
            fields = spec.split("/")
            vi = int(float(fields[0]))
            ti = int(float(fields[1])) if len(fields) > 1 and fields[1] else 0
            ni = int(float(fields[2])) if len(fields) > 2 and fields[2] else 0
            corners.append((vi, ti, ni))
        # fan triangulation (obj_loader.js:54-60)
        for i in range(len(corners) - 2):
            faces.append((corners[0], corners[i + 1], corners[i + 2]))
    return np.asarray(faces, dtype=np.int64).reshape(-1, 3, 3)


def parse_obj(text: str, prop: Optional[dict] = None,
              world_transforms=None) -> ParsedMesh:
    """Parse OBJ text applying prop transforms.

    `prop` mirrors a scene-JSON prop entry: keys scale, rotate, translate,
    normals, skips (see reference README scene schema).
    """
    prop = prop or {}
    scale = prop.get("scale", 1.0)
    rotations = prop.get("rotate", [])
    translate = prop.get("translate", [0.0, 0.0, 0.0])
    normals_mode = prop.get("normals", "flat")
    skips = set(prop.get("skips", []))

    vertex_bodies: List[str] = []
    uvs: List[List[float]] = []
    mesh_normals: List[List[float]] = []
    mtllib: Optional[str] = None

    current = DEFAULT_GROUP
    # group name -> list of face-line bodies ("1/1 3/3 2/2"); parsed in a
    # vectorized batch per group below (the reference parses per-token in JS,
    # obj_loader.js:103-116 — at 100k-face scales that loop dominates scene
    # compile, so the common formats go through one NumPy parse instead)
    group_bodies: Dict[str, List[str]] = {}
    group_order: List[str] = []

    for raw in text.split("\n"):
        s = raw.strip()
        if not s:
            continue
        tag, _, body = s.partition(" ")
        if tag == "v":
            vertex_bodies.append(body)
        elif tag == "vt":
            vals = body.split()
            u = float(vals[0]) if vals else 0.0
            v = float(vals[1]) if len(vals) > 1 else 0.0
            uvs.append([u, v])
        elif tag == "vn":
            mesh_normals.append([float(x) for x in body.split()[:3]])
        elif tag == "usemtl":
            current = body.strip()
        elif tag == "mtllib":
            mtllib = body.strip()
        elif tag == "f" and current not in skips:
            if current not in group_bodies:
                group_bodies[current] = []
                group_order.append(current)
            group_bodies[current].append(body)

    # batch-parse vertices (token count can exceed 3: "v x y z w")
    vtok = (" ".join(vertex_bodies)).split()
    if len(vtok) == 3 * len(vertex_bodies):
        verts_arr = np.array(vtok, dtype=np.float64).reshape(-1, 3)
    else:
        verts_arr = np.array(
            [[float(x) for x in b.split()[:3]] for b in vertex_bodies],
            dtype=np.float64).reshape(-1, 3)
    group_faces = {name: _parse_faces(bodies)
                   for name, bodies in group_bodies.items()}

    uv_arr = (np.asarray(uvs, dtype=np.float64).reshape(-1, 2)
              if uvs else np.zeros((0, 2)))
    vn_arr = (np.asarray(mesh_normals, dtype=np.float64).reshape(-1, 3)
              if mesh_normals else np.zeros((0, 3)))

    n_verts = len(verts_arr)
    n_vn = len(mesh_normals)

    # Transform all vertices once (vectorized).
    if n_verts:
        xverts = apply_prop_transforms(verts_arr, rotations, scale, translate,
                                       world_transforms)
    else:
        xverts = verts_arr
    if n_vn:
        xvn = apply_prop_transforms(vn_arr, rotations, scale, translate,
                                    world_transforms, rotation_only=True)
        xvn = normalize(xvn, eps=1e-30)
    else:
        xvn = vn_arr

    # Mesh-wide accumulation for smooth normals: sum of incident flat face
    # normals per vertex index (obj_loader.js:153-158,196-203).
    vert_normal_sum = np.zeros((max(n_verts, 1), 3))
    vert_normal_cnt = np.zeros((max(n_verts, 1),))

    # First pass per group: resolve indices, gather corner attributes.
    staged = []  # (name, vidx (T,3), tidx (T,3), nidx (T,3))
    for name in group_order:
        tri = group_faces[name]                       # (T, 3, 3) corner fields
        if len(tri) == 0:
            continue
        vidx = tri[:, :, 0]
        tidx = tri[:, :, 1]
        nidx = tri[:, :, 2]
        vidx = np.where(vidx < 1, n_verts + vidx + 1, vidx) - 1
        nidx = np.where(nidx < 1, n_vn + nidx + 1, nidx) - 1
        # vt indices are NOT wrapped for negative values — deliberate parity
        # with the reference, which also only wraps v/vn (obj_loader.js:
        # 103-116); a negative vt would mis-index there too.
        tidx = tidx - 1                                # may be -1 (absent)
        staged.append((name, vidx, tidx, nidx))
        if normals_mode != "mesh":
            tv = xverts[vidx]                          # (T, 3, 3)
            fn = _face_normals(tv)                     # (T, 3)
            flat_idx = vidx.reshape(-1)                # corner-major
            m = len(vert_normal_sum)
            for comp in range(3):
                vert_normal_sum[:, comp] += np.bincount(
                    flat_idx, weights=np.repeat(fn[:, comp], 3), minlength=m)
            vert_normal_cnt += np.bincount(flat_idx, minlength=m)

    groups: List[MeshGroup] = []
    bmin = np.full(3, np.inf)
    bmax = np.full(3, -np.inf)
    for name, vidx, tidx, nidx in staged:
        tv = xverts[vidx]                              # (T, 3, 3)
        bmin = np.minimum(bmin, tv.reshape(-1, 3).min(axis=0))
        bmax = np.maximum(bmax, tv.reshape(-1, 3).max(axis=0))

        if normals_mode == "mesh":
            tn = xvn[nidx]
        elif normals_mode == "smooth":
            # average (not re-normalized, matching averageNormals
            # obj_loader.js:46-52)
            cnt = np.maximum(vert_normal_cnt[vidx], 1.0)[..., None]
            tn = vert_normal_sum[vidx] / cnt
        else:  # flat
            fn = _face_normals(tv)
            tn = np.repeat(fn[:, None, :], 3, axis=1)

        has_uv = (tidx >= 0).all()
        if has_uv and len(uv_arr):
            tuv = uv_arr[np.clip(tidx, 0, len(uv_arr) - 1)]
        else:
            # spherical UVs from normalized (transformed) vertex positions
            # (obj_loader.js:63-69)
            d = normalize(tv, eps=1e-30)
            u = np.arctan2(d[..., 2], d[..., 0]) / (2.0 * np.pi)
            v = np.arcsin(np.clip(-d[..., 1], -1.0, 1.0)) / np.pi + 0.5
            tuv = np.stack([u, v], axis=-1)

        tang, bitang = compute_tangents(tv, tn, tuv)
        groups.append(MeshGroup(
            name=name, verts=tv, normals=tn, uvs=tuv,
            tangents=tang, bitangents=bitang, material={}))

    if not groups:
        bmin = np.zeros(3)
        bmax = np.zeros(3)
    return ParsedMesh(groups=groups, bounds_min=bmin, bounds_max=bmax,
                      mtllib=mtllib)


def _face_normals(tv: np.ndarray) -> np.ndarray:
    """(T,3,3) verts -> (T,3) unit geometric normals (obj_loader.js:40-44)."""
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    n = np.cross(e1, e2)
    return normalize(n, eps=1e-30)


def compute_tangents(tv: np.ndarray, tn: np.ndarray, tuv: np.ndarray):
    """Per-corner tangent frames from UV derivatives (obj_loader.js:78-100).

    tangent = normalize((dP0 * dUV1.y - dP1 * dUV0.y) / det), then per corner
    Gram-Schmidt against the shading normal.  Degenerate UV/normal cases fall
    back to an axis-aligned frame (the reference's NaN fallback at
    obj_loader.js:93-97 is buggy — it appends the NaN tangent after the fix —
    we implement the intended behavior instead).
    """
    d_pos0 = tv[:, 1] - tv[:, 0]                       # (T, 3)
    d_pos1 = tv[:, 2] - tv[:, 0]
    d_uv0 = tuv[:, 1] - tuv[:, 0]                      # (T, 2)
    d_uv1 = tuv[:, 2] - tuv[:, 0]
    det = d_uv0[:, 0] * d_uv1[:, 1] - d_uv0[:, 1] * d_uv1[:, 0]
    safe = np.abs(det) > 1e-20
    r = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)[:, None]
    pre_t = (d_pos0 * d_uv1[:, 1:2] - d_pos1 * d_uv0[:, 1:2]) * r  # (T, 3)
    pre_t = normalize(pre_t, eps=1e-30)

    pre_t3 = np.repeat(pre_t[:, None, :], 3, axis=1)   # (T, 3c, 3)
    pre_bt = np.cross(tn, pre_t3)
    tang = np.cross(pre_bt, tn)
    t_len = np.linalg.norm(tang, axis=-1, keepdims=True)
    bad = (t_len[..., 0] < 1e-12) | ~np.isfinite(t_len[..., 0]) | ~safe[:, None]
    tang = tang / np.maximum(t_len, 1e-30)
    bitang = np.cross(tn, tang)
    bitang = normalize(bitang, eps=1e-30)

    # Fallback frame: cross(n, up) with up chosen to avoid degeneracy.
    up = np.where(np.abs(tn[..., 1:2]) < 0.999,
                  np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    fb_t = np.cross(tn, up)
    fb_t = normalize(fb_t, eps=1e-30)
    fb_bt = np.cross(tn, fb_t)
    tang = np.where(bad[..., None], fb_t, tang)
    bitang = np.where(bad[..., None], fb_bt, bitang)
    return tang, bitang
