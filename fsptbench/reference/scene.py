"""The plain reference's scene compiler: a scene dict (the upstream JSON
schema) and its raw assets (OBJ text, images) -> per-triangle arrays.

It works out again, from the raw inputs, what the program's set-up derives:
the triangle soup with its shading frames and texture coordinates, the
material maps resampled to the atlas resolution, the decoded environment
and its importance bins.  Its triangles stay in file order; no BVH layout,
slot padding or packed table enters here (reference/bvh.py builds its own
tree).  The rules are the upstream loader's (obj_loader.js,
texture_packer.js, env_sampler.js), written out plainly in NumPy.

Supported: props with v/vt/f OBJ text, rotate/scale/translate, "smooth" and
"flat" normals, flat or image material maps, RGBE or gradient
environments, assets of any generator (fsptbench/scenegen.py: built in or
found by name under generators/), and the area lights that light NEE
samples: every triangle of a prop whose emittance sums to more than 0, in
file order, with their total area and an area-weighted CDF.  Anything else
raises (a multi-material OBJ too: a configuration gives each material a
prop of its own), so a configuration the reference cannot state is refused
rather than compared loosely.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

LUMA = np.array([0.2126, 0.7152, 0.0722])


def _normalize(v, eps=1e-30):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


# ---- OBJ -----------------------------------------------------------------

def parse_obj(text: str):
    """-> (verts (V,3) f64, uvs (U,2) f64, faces (T,3,2) int: per corner
    the 0-based vertex index and uv index (-1 when absent))."""
    verts, uvs, faces = [], [], []
    for raw in text.split("\n"):
        parts = raw.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            uvs.append([float(parts[1]) if len(parts) > 1 else 0.0,
                        float(parts[2]) if len(parts) > 2 else 0.0])
        elif tag == "f":
            corners = []
            for spec in parts[1:]:
                fields = spec.split("/")
                vi = int(fields[0])
                ti = int(fields[1]) if len(fields) > 1 and fields[1] else 0
                corners.append((vi, ti))
            for i in range(len(corners) - 2):
                faces.append((corners[0], corners[i + 1], corners[i + 2]))
        elif tag in ("usemtl", "mtllib", "vn"):
            raise NotImplementedError(f"reference OBJ: {tag!r} statements")
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3, 2)
    vidx = f[..., 0]
    vidx = np.where(vidx < 1, len(v) + vidx + 1, vidx) - 1
    return v, np.asarray(uvs, np.float64).reshape(-1, 2), \
        np.stack([vidx, f[..., 1] - 1], axis=-1)


def _rotate(verts, axis, angle):
    u = _normalize(np.asarray(axis, np.float64))
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = u
    m = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    return verts @ m.T


def _face_normals(tv):
    return _normalize(np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))


def _tangents(tv, tn, tuv):
    """Per-corner tangent frames from the uv derivatives, Gram-Schmidt
    against the shading normal, with an axis frame where they degenerate
    (obj_loader.js:78-100, its intended behaviour)."""
    d_pos0 = tv[:, 1] - tv[:, 0]
    d_pos1 = tv[:, 2] - tv[:, 0]
    d_uv0 = tuv[:, 1] - tuv[:, 0]
    d_uv1 = tuv[:, 2] - tuv[:, 0]
    det = d_uv0[:, 0] * d_uv1[:, 1] - d_uv0[:, 1] * d_uv1[:, 0]
    safe = np.abs(det) > 1e-20
    r = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)[:, None]
    pre_t = _normalize((d_pos0 * d_uv1[:, 1:2] - d_pos1 * d_uv0[:, 1:2]) * r)
    pre_t3 = np.repeat(pre_t[:, None, :], 3, axis=1)
    tang = np.cross(np.cross(tn, pre_t3), tn)
    t_len = np.linalg.norm(tang, axis=-1, keepdims=True)
    bad = ((t_len[..., 0] < 1e-12) | ~np.isfinite(t_len[..., 0])
           | ~safe[:, None])
    tang = tang / np.maximum(t_len, 1e-30)
    bitang = _normalize(np.cross(tn, tang))
    up = np.where(np.abs(tn[..., 1:2]) < 0.999, np.array([0.0, 1.0, 0.0]),
                  np.array([1.0, 0.0, 0.0]))
    fb_t = _normalize(np.cross(tn, up))
    fb_bt = np.cross(tn, fb_t)
    return (np.where(bad[..., None], fb_t, tang),
            np.where(bad[..., None], fb_bt, bitang))


def mesh(text: str, prop: dict):
    """One prop's triangles: positions (T,3,3), shading normals, uvs,
    tangents, bitangents, all float64."""
    if prop.get("skips") or prop.get("normals", "flat") not in (
            "smooth", "flat"):
        raise NotImplementedError("reference OBJ: skips / mesh normals")
    v, uv, f = parse_obj(text)
    for r in prop.get("rotate") or []:
        v = _rotate(v, r["axis"], r["angle"])
    v = v * float(prop.get("scale", 1.0)) + np.asarray(
        prop.get("translate", [0.0, 0.0, 0.0]), np.float64)
    vidx, tidx = f[..., 0], f[..., 1]
    tv = v[vidx]
    fn = _face_normals(tv)
    if prop.get("normals", "flat") == "smooth":
        # the mean of the incident face normals, not re-normalised
        s = np.zeros((len(v), 3))
        np.add.at(s, vidx.reshape(-1), np.repeat(fn, 3, axis=0))
        cnt = np.bincount(vidx.reshape(-1), minlength=len(v))
        tn = s[vidx] / np.maximum(cnt[vidx], 1.0)[..., None]
    else:
        tn = np.repeat(fn[:, None, :], 3, axis=1)
    if (tidx >= 0).all() and len(uv):
        tuv = uv[np.clip(tidx, 0, len(uv) - 1)]
    else:
        d = _normalize(tv)
        tuv = np.stack([np.arctan2(d[..., 2], d[..., 0]) / (2.0 * np.pi),
                        np.arcsin(np.clip(-d[..., 1], -1.0, 1.0)) / np.pi
                        + 0.5], axis=-1)
    tang, bitang = _tangents(tv, tn, tuv)
    return tv, tn, tuv, tang, bitang


# ---- material maps -------------------------------------------------------

def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _resize(img, res):
    """Bilinear resize with edge clamping (GL LINEAR)."""
    h, w = img.shape[:2]
    if (h, w) == (res, res):
        return img
    ys = (np.arange(res) + 0.5) * h / res - 0.5
    xs = (np.arange(res) + 0.5) * w / res - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    return (img[y0][:, x0] * (1 - fy) * (1 - fx)
            + img[y0][:, x1] * (1 - fy) * fx
            + img[y1][:, x0] * fy * (1 - fx)
            + img[y1][:, x1] * fy * fx).astype(img.dtype)


def _map_image(img, res, corrected, swizzle):
    img = np.asarray(img)
    img = (img.astype(np.float32) / 255.0 if img.dtype == np.uint8
           else img.astype(np.float32))
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    img = _resize(img, res)
    if swizzle is not None:
        sw = list(swizzle) + [3] * (4 - len(swizzle))
        img = img[..., sw[:4]]
    rgb = img[..., :3]
    if corrected:
        rgb = _srgb_to_linear(rgb)
    return (rgb * img[..., 3:4]).astype(np.float32)


def _flat(color, res):
    c = np.floor(np.clip(np.asarray(color, np.float32)[:3], 0, 1) * 255.0)
    return np.broadcast_to((c / 255.0).astype(np.float32),
                           (res, res, 3)).copy()


def _prop_maps(prop):
    """(kind, value, corrected, swizzle) of the diffuse, emissive, normal
    and metallic-roughness maps of a prop (main.js getMaterial, no MTL)."""
    def pick(value, default, corrected=False, swizzle=None):
        if isinstance(value, str):
            return ("image", value, corrected, swizzle)
        if isinstance(value, (list, tuple)):
            return ("color", value, False, None)
        return ("color", default, False, None)
    sw = prop.get("mrSwizzle")
    emission = prop.get("emission")
    normal = prop.get("normal")
    if normal and not isinstance(normal, str):
        raise NotImplementedError("reference scene: a non-path normal map")
    return (pick(prop.get("diffuse"), [0.5, 0.5, 0.5], corrected=True),
            pick(emission if isinstance(emission, str) else None,
                 [0.0, 0.0, 0.0]),
            pick(normal or None, [0.5, 0.5, 1.0]),
            pick(prop.get("metallicRoughness"), [0.0, 0.3, 0.0],
                 swizzle=[int(x) for x in sw] if sw else None))


# ---- environment ---------------------------------------------------------

def decode_rgbe(pixels):
    p = pixels.astype(np.float32)
    return (p[..., :3] / 255.0) * np.exp2(p[..., 3] - 128.0)[..., None]


def gradient_environment(stops, height=2048):
    stops = np.asarray(stops, np.float32)
    n = len(stops) - 1
    rows = np.arange(height)
    seg = np.minimum((rows // (height / n)).astype(np.int64), n - 1)
    sigma = ((rows % (height / n)) / (height / n)).astype(np.float32)
    return (stops[seg] * (1.0 - sigma[:, None])
            + stops[seg + 1] * sigma[:, None]).reshape(height, 1, 3)


def radiance_bins(radiance, divisor=64.0):
    """Bi-tree split of the equirect image into boxes of summed luma <=
    max(total / 64, brightest / 2), first half before second half
    (env_sampler.js:24-72), with box sums taken directly."""
    h, w = radiance.shape[:2]
    luma = (radiance[..., 0] * LUMA[0] + radiance[..., 1] * LUMA[1]
            + radiance[..., 2] * LUMA[2])
    sat = np.zeros((h + 1, w + 1))
    sat[1:, 1:] = np.cumsum(np.cumsum(luma, axis=0), axis=1)
    total = float(sat[h, w])
    limit = max(total / divisor, float(luma.max()) / 2.0)
    boxes: List[List[int]] = []

    def split(rad, x0, y0, x1, y1):
        if rad <= limit or (y1 - y0) * (x1 - x0) < 2:
            boxes.append([x0, y0, x1, y1])
            return
        vert = (x1 - x0) > (y1 - y0)
        if vert:
            xs, ys = x0 + (x1 - x0) // 2, y1
        else:
            xs, ys = x1, y0 + (y1 - y0) // 2
        sub = sat[ys, xs] - sat[y0, xs] - sat[ys, x0] + sat[y0, x0]
        split(sub, x0, y0, xs, ys)
        if vert:
            split(rad - sub, xs, y0, x1, y1)
        else:
            split(rad - sub, x0, ys, x1, y1)

    split(total, 0, 0, w, h)
    return np.asarray(boxes, np.float32).reshape(-1, 4)


# ---- the whole scene -----------------------------------------------------

@dataclasses.dataclass
class RefScene:
    v0: torch.Tensor          # (T, 3) f32 triangle corner 0
    e1: torch.Tensor          # (T, 3) f32 corner 1 - corner 0
    e2: torch.Tensor
    attr: torch.Tensor        # (T, 38) f32: 3 normals, 3 tangents,
    #                           3 bitangents, 3 uvs, emittance, ior,
    #                           dielectric (corner-major, as listed)
    maps: torch.Tensor        # (T, 4) int64 layers: diffuse, emissive,
    #                           normal, metallic-roughness
    atlas: torch.Tensor       # (L, R, R, 3) f32
    env: torch.Tensor         # (H, W, 3) f32
    bins: torch.Tensor        # (B, 4) f32 [x0, y0, x1, y1]
    env_theta: float
    camera: dict
    samples: int
    lights: torch.Tensor      # (Lt,) int64 triangle ids of the emitters
    light_cdf: torch.Tensor   # (Lt,) f32 area-weighted CDF, ending at 1
    light_area: float         # their total area (f32)


def compile_scene(scene: dict, loader, device) -> RefScene:
    for unsupported in ("normalize", "worldTransforms", "static_props",
                        "animated_props"):
        if scene.get(unsupported):
            raise NotImplementedError(f"reference scene: {unsupported}")
    env_spec = scene.get("environment")
    if isinstance(env_spec, str):
        env = decode_rgbe(loader.image(env_spec))
        bins = radiance_bins(env)
    else:
        env = gradient_environment(env_spec or [[0, 0, 0], [0, 0, 0]])
        bins = np.array([[0, 0, env.shape[1], env.shape[0]]], np.float32)

    props = scene.get("props") or []
    images = {}
    for prop in props:
        for kind, value, _, _ in _prop_maps(prop):
            if kind == "image":
                images[value] = loader.image(value)
    res = min(int(scene.get("atlasRes", 2048)),
              max([1] + [im.shape[0] for im in images.values()]))

    layers, parts = [], []
    for prop in props:
        tv, tn, tuv, tang, bitang = mesh(loader.text(prop["path"]), prop)
        ids = []
        for kind, value, corrected, swizzle in _prop_maps(prop):
            ids.append(len(layers))
            layers.append(_map_image(images[value], res, corrected, swizzle)
                          if kind == "image" else _flat(value, res))
        m = len(tv)
        emittance = np.asarray(prop.get("emittance", [0, 0, 0]),
                               np.float64)[:3]
        emit = np.broadcast_to(emittance, (m, 3))
        ior = float(prop.get("ior") or 1.4)
        diel = float(prop.get("dielectric") or -1.0)
        parts.append((tv, np.concatenate(
            [tn.reshape(m, 9), tang.reshape(m, 9), bitang.reshape(m, 9),
             tuv.reshape(m, 6), emit, np.full((m, 1), ior),
             np.full((m, 1), diel)], axis=1), np.tile(ids, (m, 1)),
            emittance.sum() > 0))
    if not parts:
        raise ValueError("scene contains no geometry")
    tv = np.concatenate([p[0] for p in parts]).astype(np.float32)
    f32 = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(device)
    first = np.cumsum([0] + [len(p[0]) for p in parts])
    lights = np.concatenate([np.arange(first[i], first[i + 1])
                             for i, p in enumerate(parts) if p[3]] + [[]]
                            ).astype(np.int64)
    e1 = tv[lights, 1].astype(np.float64) - tv[lights, 0]
    e2 = tv[lights, 2].astype(np.float64) - tv[lights, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    return RefScene(
        v0=f32(tv[:, 0]), e1=f32(tv[:, 1] - tv[:, 0]),
        e2=f32(tv[:, 2] - tv[:, 0]),
        attr=f32(np.concatenate([p[1] for p in parts])),
        maps=torch.from_numpy(np.concatenate([p[2] for p in parts])
                              .astype(np.int64)).to(device),
        atlas=f32(np.stack(layers)), env=f32(env), bins=f32(bins),
        env_theta=float(np.float32(scene.get("environmentTheta", 0.0))),
        camera={"position": scene.get("cameraPos", [0.0, 0.0, 2.0]),
                "direction": scene.get("cameraDir", [0.0, 0.0, -1.0]),
                "fov_scale": float(scene.get("fovScale", 0.5)),
                "focal_depth": 1e6, "aperture": 0.0},
        samples=int(scene.get("samples", 2000)),
        lights=torch.from_numpy(lights).to(device),
        light_cdf=f32(np.cumsum(area) / max(area.sum(), 1e-30)),
        light_area=float(np.float32(area.sum())))
