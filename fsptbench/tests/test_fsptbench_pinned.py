"""The existing configurations' inputs and the reference's step, pinned:
the generated assets of bunny8_main and bunny4_cli at their own sizes,
and the reference's summed radiance of one step at 32x32 (a bunny of 2
subdivisions), float32 and the bfloat16 control, by SHA-256 of their
bytes.  The digests were taken before the harness learned generator files
and light NEE; a change that moves them moves what the existing cells
compare.  They are of torch's CPU arithmetic and hold on one torch build."""

import copy
import hashlib

import numpy as np
import pytest

from fsptbench.manifest import Manifest
from fsptbench.reference.render import Reference, config
from fsptbench.reference.scene import compile_scene
from fsptbench.scenegen import Assets

SEED = 3_123_456_789
ASSETS = {"bunny.obj": "e9b6ac21d5027798", "checker.png": "dcaf0a5f985bc5a7",
          "floor.obj": "bfd042f278747bbc", "sky.rgbe.png": "8c3686f963bf9cac"}
STEPS = {"bunny8_main": ("6beef2a00a5d8768", "6553cfed69d4d4ca"),
         "bunny4_cli": ("e14cad45f1b8ad5a", "a4ea4362c1484ed4")}


def digest(x) -> str:
    if isinstance(x, str):
        b = x.encode()
    else:
        a = np.ascontiguousarray(np.asarray(x))
        b = f"{a.dtype.str}{a.shape}".encode() + a.tobytes()
    return hashlib.sha256(b).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_generated_assets_are_pinned(name):
    c = Manifest().config(name)
    got = {k: digest(v) for k, v in Assets(c["assets"]).items.items()}
    assert got == ASSETS


@pytest.mark.parametrize("lowp", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(STEPS))
def test_reference_step_is_pinned(name, lowp):
    c = copy.deepcopy(Manifest().config(name))
    c["assets"]["bunny.obj"]["subdivisions"] = 2
    scene = compile_scene(c["scene"], Assets(c["assets"]), "cpu")
    r = config(dict(c["render"], width=32, height=32), SEED)
    rad = Reference(scene, r, lowp=lowp).step(scene.camera, (32, 32), SEED,
                                               5, r["batch_spp"])
    assert digest(rad.numpy()) == STEPS[name][lowp]
