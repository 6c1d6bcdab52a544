"""The port's jax-free host scene compiler (fspt_tpu_torch.scene & co.)
against the JAX package's original.

fspt_tpu's host modules cannot be imported without JAX
(fspt_tpu/__init__.py imports the renderer, and scene/schema.py imports
core.vec), so the port carries copies.  These tests hold the copies to the
originals: sources equal up to the import rewrite, byte-identical
SceneArrays and an equal SceneMeta, and a lossless carry onto torch.
Modules that mix host and device code (scene/refit.py, runtime/animation.py,
runtime/viewer.py) carry copies of their host functions and constants, each
held to its original the same way.  A subprocess with JAX blocked imports
the port (the refit, animation and viewer modules too) and renders one step
under "split", one under the default config ("walk") and one heatmap step.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fspt_tpu import testing as jax_testing
from fspt_tpu_torch import testing as torch_testing
from fspt_tpu_torch.core.vec import V3
from fspt_tpu_torch.scene.schema import SceneArrays, scene_to_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules copied verbatim except for their import paths
COPIED = ["config.py", "scene/transforms.py", "scene/obj.py", "scene/mtl.py",
          "scene/atlas.py", "scene/envmap.py", "scene/bvh.py",
          "scene/fastbvh.py", "native/__init__.py", "native/bvh_builder.cpp",
          "ops/packing.py", "runtime/layout.py", "io/image.py", "testing.py",
          "scene/schema.py", "tools/diff.py"]


def _read(pkg, rel):
    with open(os.path.join(ROOT, pkg, rel)) as f:
        return f.read()


def _rewrite_imports(src):
    src = re.sub(r"^(\s*)from fspt_tpu\.", r"\1from fspt_tpu_torch.", src,
                 flags=re.M)
    return re.sub(r"^(\s*)from fspt_tpu import ",
                  r"\1from fspt_tpu_torch import ", src, flags=re.M)


def _drop_device_handoff(src):
    """schema.py's one sanctioned edit: Scene.device_arrays (JAX) became
    Scene.to_torch + scene_to_torch."""
    start = re.search(r"^    def (device_arrays|to_torch)\(", src, re.M)
    end = src.index("\nclass AssetLoader")
    return src[:start.start()] + src[end:]


@pytest.mark.parametrize("rel", COPIED)
def test_host_copy_matches_original(rel):
    orig = _rewrite_imports(_read("fspt_tpu", rel))
    port = _read("fspt_tpu_torch", rel)
    if rel == "scene/schema.py":
        orig, port = _drop_device_handoff(orig), _drop_device_handoff(port)
    assert port == orig, f"{rel} drifted from fspt_tpu/{rel}"


# functions and constants copied out of modules whose device code the port
# re-writes: (module, top-level name)
COPIED_DEFS = (
    [("scene/refit.py", n) for n in ("RefitAux", "prop_affine",
                                     "build_refit_aux", "delta_affines")]
    + [("runtime/animation.py", n) for n in ("_lerp", "interpolate_keyframes",
                                             "scene_for_frame")]
    + [("runtime/viewer.py", n) for n in ("_rotate_y", "_rotate_axis",
                                          "_PAGE")])


def _top_level_source(pkg, rel, name):
    src = _read(pkg, rel)
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        else:
            names = [t.id for t in getattr(node, "targets", [])
                     if isinstance(t, ast.Name)]
        if name in names:
            return ast.get_source_segment(src, node)
    raise AssertionError(f"{pkg}/{rel} defines no {name}")


@pytest.mark.parametrize("rel,name", COPIED_DEFS)
def test_host_function_copy_matches_original(rel, name):
    orig = _rewrite_imports(_top_level_source("fspt_tpu", rel, name))
    assert _top_level_source("fspt_tpu_torch", rel, name) == orig, (
        f"{name} of {rel} drifted from fspt_tpu/{rel}")


def test_port_has_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "fspt_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]    # build outputs only
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), os.path.join(dirpath, f)


def _assert_same(a, b, path):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert a.tobytes() == b.tobytes(), path


SCENES = {
    "plain": ("make_test_scene", dict(subdivisions=2)),
    "textured": ("make_test_scene", dict(subdivisions=2, textured=True)),
    "dielectric": ("make_test_scene", dict(subdivisions=2, dielectric=0.4,
                                           ior=1.5)),
    "bunny3": ("make_bunny_standin_scene", dict(subdivisions=3)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_arrays_byte_identical(name):
    fn, kw = SCENES[name]
    ref = getattr(jax_testing, fn)(**kw)
    port = getattr(torch_testing, fn)(**kw)
    for field in SceneArrays._fields:
        _assert_same(getattr(port.arrays, field), getattr(ref.arrays, field),
                     field)
    for attr in ("meta", "camera", "post"):
        assert (dataclasses.asdict(getattr(port, attr))
                == dataclasses.asdict(getattr(ref, attr))), attr
    assert port.num_triangles == ref.num_triangles


@pytest.mark.parametrize("source", ["port", "jax"])
def test_scene_to_torch_roundtrip(source):
    mod = torch_testing if source == "port" else jax_testing
    scene = mod.make_test_scene(subdivisions=1, textured=True)
    t = scene_to_torch(scene.arrays, "cpu")
    for field in SceneArrays._fields:
        a, b = getattr(scene.arrays, field), getattr(t, field)
        if isinstance(a, tuple):
            assert isinstance(b, V3)
        else:
            assert torch.is_tensor(b)
        back = (tuple(x.numpy() for x in b) if isinstance(b, tuple)
                else b.numpy())
        _assert_same(back, a, field)


def test_port_renders_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import fspt_tpu_torch as ft\n"
        "import fspt_tpu_torch.scene.refit, fspt_tpu_torch.runtime.animation\n"
        "import fspt_tpu_torch.runtime.viewer, fspt_tpu_torch.__main__\n"
        "from fspt_tpu_torch.testing import make_test_scene\n"
        "scene = make_test_scene(subdivisions=1)\n"
        "for kw in (dict(intersector='split'), dict(), "
        "dict(mode='bvh_heatmap')):\n"
        "    cfg = ft.RenderConfig(width=32, height=32, bounces=2,\n"
        "        extra_refraction_iters=0, **kw)\n"
        "    r = ft.Renderer(scene, cfg, device='cpu')\n"
        "    img = r.step().hdr_image()\n"
        "    assert img.shape == (32, 32, 3) and np.isfinite(img).all()\n"
        "    assert img.mean() > 0\n"
        "assert ft.RenderConfig().intersector == 'walk'\n"
        "assert not any(m == 'jax' or m.startswith('jax.')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
