"""Procedural test scenes and in-memory asset loading.

The reference mount is missing its large assets (bunny_big.obj, the RGBE env
PNG — /root/reference/.MISSING_LARGE_BLOBS), so benchmarks and golden tests
use procedurally generated stand-ins with the same schema coverage: an
icosphere "bunny" over a floor quad, PBR texture maps, and an RGBE-encoded
HDR sky with a bright sun (exercising env importance sampling).
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np

from fspt_tpu_torch.scene.envmap import encode_rgbe
from fspt_tpu_torch.scene.schema import Scene, load_scene_dict


class DictAssetLoader:
    """AssetLoader over in-memory dicts (no filesystem)."""

    def __init__(self, texts: Optional[Dict[str, str]] = None,
                 images: Optional[Dict[str, np.ndarray]] = None):
        self.texts = texts or {}
        self.images = images or {}

    def text(self, path: str) -> str:
        return self.texts[path]

    def image(self, path: str) -> np.ndarray:
        img = self.images[path]
        if img.ndim == 2:
            img = np.stack([img] * 3 + [np.full_like(img, 255)], axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full_like(img[..., :1], 255)], axis=-1)
        return img

    def exists(self, path: str) -> bool:
        return path in self.texts or path in self.images


# ---------------------------------------------------------------------------
# procedural meshes (emitted as OBJ text so the parser is on the test path)
# ---------------------------------------------------------------------------

def icosphere_obj(subdivisions: int = 2) -> str:
    """Unit icosphere OBJ; 20 * 4^n faces."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    faces = np.asarray(faces, dtype=np.int64)

    # Vectorized midpoint subdivision with np.unique edge dedup, preserving
    # the exact vertex/face emission order of the original per-face loop
    # (midpoints numbered in first-encounter order over (a,b),(b,c),(c,a)
    # per face) so BVH-structure-sensitive goldens stay stable.
    for _ in range(subdivisions):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                          np.stack([c, a], 1)], axis=1).reshape(-1, 2)
        edges = np.sort(edges, axis=1)
        uniq, first_idx, inv = np.unique(edges, axis=0, return_index=True,
                                         return_inverse=True)
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[np.argsort(first_idx, kind="stable")] = np.arange(len(uniq))
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        fe_order = np.argsort(rank, kind="stable")   # uniq idx per new vertex
        base = len(verts)
        verts = np.concatenate([verts, mids[fe_order]])
        new_id = base + rank[inv].reshape(-1, 3)     # (F, 3): ab, bc, ca
        ab, bc, ca = new_id[:, 0], new_id[:, 1], new_id[:, 2]
        faces = np.stack([
            np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
            axis=1).reshape(-1, 3)

    buf = io.StringIO()
    for v in verts:
        buf.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
    for f in faces:
        buf.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
    return buf.getvalue()


def quad_obj() -> str:
    """Unit floor quad in the XZ plane (like reference top_mono.obj).

    Winding chosen so the flat normal points +y (up): the integrator treats
    back-face hits as "inside" (reference tracer.fs:461-463) and applies the
    Beer term with dielectric=-1, which brightens opaque floors — an earlier
    version of this quad wound the faces downward and silently hit that path
    on every floor bounce."""
    return (
        "v 0.5 0.0 0.5\nv 0.5 0.0 -0.5\nv -0.5 0.0 -0.5\nv -0.5 0.0 0.5\n"
        "vt 0.0 0.0\nvt 0.0 1.0\nvt 1.0 1.0\nvt 1.0 0.0\n"
        "f 1/1 2/2 3/3\nf 3/3 4/4 1/1\n"
    )


def sky_rgbe(width: int = 512, height: int = 256,
             sun_u: float = 0.25, sun_v: float = 0.3,
             sun_radiance: float = 200.0) -> np.ndarray:
    """Procedural equirect HDR sky (gradient + sun disk) as RGBE uint8."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    horizon = np.clip(1.0 - np.abs(vv - 0.5) * 2.0, 0.0, 1.0)
    sky = np.stack([
        0.2 + 0.3 * horizon,
        0.35 + 0.35 * horizon,
        0.7 + 0.2 * horizon,
    ], axis=-1)
    du = np.minimum(np.abs(uu - sun_u), 1.0 - np.abs(uu - sun_u)) * 2.0
    dv = np.abs(vv - sun_v)
    sun = (du ** 2 + dv ** 2) < 0.03 ** 2
    radiance = np.where(sun[..., None],
                        np.array([1.0, 0.95, 0.8]) * sun_radiance, sky)
    return encode_rgbe(radiance.astype(np.float32))


def checker_texture(res: int = 64, squares: int = 8) -> np.ndarray:
    """(res, res, 4) uint8 checkerboard."""
    idx = np.arange(res) * squares // res
    board = (idx[:, None] + idx[None, :]) % 2
    img = np.where(board[..., None] == 0,
                   np.array([200, 60, 60, 255], dtype=np.uint8),
                   np.array([240, 240, 240, 255], dtype=np.uint8))
    return img.astype(np.uint8)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def make_test_scene(subdivisions: int = 2, textured: bool = False,
                    env: str = "sky", metallic: float = 0.0,
                    roughness: float = 0.3, ior: float = 1.4,
                    dielectric: float = -1.0, leaf_size: int = 8,
                    env_bins_cap: int = 256,
                    emissive_sphere: bool = False,
                    bvh_width: int = 8) -> Scene:
    """Icosphere over a floor quad; scene-JSON-schema driven."""
    loader = DictAssetLoader(
        texts={"sphere.obj": icosphere_obj(subdivisions),
               "floor.obj": quad_obj()},
        images={"sky.rgbe.png": sky_rgbe(),
                "checker.png": checker_texture()},
    )
    sphere_prop = {
        "path": "sphere.obj",
        "scale": 0.5,
        "translate": [0.0, 0.0, 0.0],
        "diffuse": [0.9, 0.4, 0.3],
        "metallicRoughness": [metallic, roughness, 0.0],
        "ior": ior,
        "normals": "smooth",
    }
    if dielectric >= 0:
        sphere_prop["dielectric"] = dielectric
    if emissive_sphere:
        sphere_prop["emittance"] = [4.0, 3.5, 3.0]
    floor_prop = {
        "path": "floor.obj",
        "scale": 6.0,
        "translate": [0.0, -0.5, 0.0],
        "diffuse": "checker.png" if textured else [0.6, 0.6, 0.6],
        "metallicRoughness": [0.0, 0.6, 0.0],
        "normals": "flat",
    }
    scene = {
        "environment": ("sky.rgbe.png" if env == "sky"
                        else [[0.1, 0.1, 0.2], [0.7, 0.8, 1.0]]),
        "environmentTheta": 0.0,
        "cameraPos": [0.0, 0.4, 2.2],
        "cameraDir": [0.0, -0.18, -0.98],
        "fovScale": 0.5,
        "samples": 64,
        "atlasRes": 64,
        "props": [sphere_prop, floor_prop],
    }
    # width 8 so tests can drive BOTH kernels (the v1 packet kernel reads
    # the 8-wide layout only).  The production/bench loaders also default
    # to 8 (16-wide measured slower, scene/schema.py); the 16-wide pack/
    # traverse generalization is covered by tests/test_fastbvh.py's
    # parametrized width-16 hit-parity test.
    return load_scene_dict(scene, loader, leaf_size=leaf_size,
                           env_bins_cap=env_bins_cap, name="procedural",
                           bvh_width=bvh_width)


def make_bunny_standin_scene(subdivisions: int = 6, leaf_size: int = 8,
                             env_bins_cap: int = 256,
                             bvh_width: int = 8) -> Scene:
    """Benchmark-scale stand-in for scene/bunny.json (~80k+ triangles,
    HDRi env with importance bins, mixed materials)."""
    loader = DictAssetLoader(
        texts={"bunny.obj": icosphere_obj(subdivisions),
               "floor.obj": quad_obj()},
        images={"sky.rgbe.png": sky_rgbe(1024, 512),
                "checker.png": checker_texture(256)},
    )
    scene = {
        "environment": "sky.rgbe.png",
        "environmentTheta": 1.66,
        "cameraPos": [-0.751, 0.665, 1.82],
        "cameraDir": [0.304, -0.489, -0.818],
        "samples": 2000,
        "atlasRes": 256,
        "props": [
            {"path": "bunny.obj", "scale": 0.35, "translate": [0.1, -0.2, 0],
             "diffuse": [1, 1, 1], "metallicRoughness": [0, 0.1, 0],
             "ior": 1.4, "normals": "smooth"},
            {"path": "floor.obj", "scale": 4,
             "translate": [0, -0.75, 0], "diffuse": "checker.png",
             "metallicRoughness": [0.0, 0.5, 0.0], "normals": "flat"},
        ],
    }
    return load_scene_dict(scene, loader, leaf_size=leaf_size,
                           env_bins_cap=env_bins_cap, name="bunny_standin",
                           bvh_width=bvh_width)
