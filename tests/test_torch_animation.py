"""The port's animation loop (fspt_tpu_torch.runtime.animation) and its
`animate` command, on the CPU.

tests/test_tools.py's keyframe, merged-scene and resumable-animation tests
on the port; the copied keyframe functions against the JAX package's on the
same dicts; and `animate` through the command line's parser, with and
without --refit, writing its frames.
"""

import json
import os

import numpy as np
import pytest
import torch

from fspt_tpu_torch.runtime.animation import (interpolate_keyframes,
                                              render_animation,
                                              scene_for_frame)
from fspt_tpu_torch.testing import DictAssetLoader, icosphere_obj, quad_obj

torch.set_num_threads(1)


# ---- tests/test_tools.py:83-143, on the port ------------------------------

def test_keyframe_interpolation():
    prop = {"path": "x.obj",
            "keyframes": [
                {"frame": 0, "translate": [0, 0, 0], "scale": 1.0,
                 "rotate": [{"axis": [0, 1, 0], "angle": 0.0}]},
                {"frame": 10, "translate": [10, 0, 0], "scale": 3.0,
                 "rotate": [{"axis": [0, 1, 0], "angle": 1.0}]},
            ]}
    mid = interpolate_keyframes(prop, 5)
    np.testing.assert_allclose(mid["translate"], [5, 0, 0])
    np.testing.assert_allclose(mid["scale"], 2.0)
    np.testing.assert_allclose(mid["rotate"][0]["angle"], 0.5)
    # clamped outside range
    assert interpolate_keyframes(prop, 99)["translate"] == [10, 0, 0]
    # props without keyframes pass through
    assert interpolate_keyframes({"path": "y.obj"}, 3) == {"path": "y.obj"}


def test_scene_for_frame_merges_animated():
    scene = {"props": [{"path": "a.obj"}],
             "animated_props": {
                 "spin": {"path": "b.obj",
                          "keyframes": [{"frame": 0, "scale": 1.0},
                                        {"frame": 2, "scale": 2.0}]}}}
    out = scene_for_frame(scene, 1)
    assert out["animated_props"]["spin"]["scale"] == 1.5
    assert "keyframes" not in out["animated_props"]["spin"]


def test_render_animation_resumable(tmp_path):
    from fspt_tpu_torch.config import RenderConfig

    loader = DictAssetLoader(texts={"s.obj": icosphere_obj(0),
                                    "f.obj": quad_obj()})
    scene_dict = {
        "environment": [[0.5, 0.5, 0.6], [0.1, 0.1, 0.1]],
        "cameraPos": [0, 0.4, 2.2], "cameraDir": [0, -0.18, -0.98],
        "props": [{"path": "f.obj", "scale": 6,
                   "translate": [0, -0.5, 0], "diffuse": [0.6, 0.6, 0.6]}],
        "animated_props": {
            "ball": {"path": "s.obj", "scale": 0.5,
                     "diffuse": [0.9, 0.4, 0.3],
                     "keyframes": [{"frame": 0, "translate": [-1, 0, 0]},
                                   {"frame": 3, "translate": [1, 0, 0]}]}},
    }
    cfg = RenderConfig(width=16, height=16, bounces=1,
                       extra_refraction_iters=0, batch_spp=2)
    out = str(tmp_path / "frames")
    paths = render_animation(scene_dict, loader, out, range(0, 2),
                             config=cfg, samples=2, device="cpu")
    assert all(os.path.exists(p) for p in paths)
    # resume: second call skips everything (mtimes unchanged)
    mtimes = [os.path.getmtime(p) for p in paths]
    paths2 = render_animation(scene_dict, loader, out, range(0, 2),
                              config=cfg, samples=2, device="cpu")
    assert [os.path.getmtime(p) for p in paths2] == mtimes
    # frames differ (the ball moved)
    from fspt_tpu_torch.io.image import read_png
    assert not np.array_equal(read_png(paths[0]), read_png(paths[1]))


# ---- the copies against the JAX package's functions -----------------------

KEYFRAMED = {
    "list": {"props": [{"path": "a.obj", "scale": 2.0}],
             "animated_props": [
                 {"path": "b.obj", "translate": [1.0, 0.0, 0.0],
                  "keyframes": [
                      {"frame": 1, "translate": [0.0, 0.0, 0.0],
                       "rotate": [{"axis": [0, 1, 0], "angle": 0.2},
                                  {"axis": [1, 0, 0], "angle": -0.4}]},
                      {"frame": 4, "translate": [2.0, -1.0, 0.5],
                       "scale": 0.25,
                       "rotate": [{"axis": [0, 1, 0], "angle": 1.4}]}]}]},
    "dict": {"animated_props": {
        "spin": {"path": "c.obj", "scale": 0.7,
                 "keyframes": [{"frame": 3, "scale": 1.5},
                               {"frame": 0, "scale": 0.5,
                                "translate": [0.0, 1.0, 0.0]}]},
        "still": {"path": "d.obj"}}},
}


@pytest.mark.parametrize("name", sorted(KEYFRAMED))
def test_keyframes_match_jax(name):
    from fspt_tpu.runtime import animation as jax_animation
    sd = KEYFRAMED[name]
    for frame in (-1, 0, 1, 2, 3, 4, 7):
        assert (scene_for_frame(sd, frame)
                == jax_animation.scene_for_frame(sd, frame)), frame
        props = sd["animated_props"]
        for prop in (props.values() if isinstance(props, dict) else props):
            assert (interpolate_keyframes(prop, frame)
                    == jax_animation.interpolate_keyframes(prop, frame))


# ---- the animate command ---------------------------------------------------

@pytest.fixture
def anim_file(tmp_path):
    (tmp_path / "mesh.obj").write_text(icosphere_obj(0))
    (tmp_path / "floor.obj").write_text(quad_obj())
    path = tmp_path / "anim.json"
    path.write_text(json.dumps({
        "environment": [[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]],
        "cameraPos": [0, 0.4, 2.2], "cameraDir": [0, -0.18, -0.98],
        "props": [{"path": "floor.obj", "scale": 6,
                   "translate": [0, -0.5, 0], "diffuse": [0.6, 0.6, 0.6]}],
        "animated_props": [
            {"path": "mesh.obj", "scale": 0.5, "diffuse": [1, 0, 0],
             "keyframes": [{"frame": 0, "translate": [-0.5, 0, 0]},
                           {"frame": 1, "translate": [0.5, 0, 0],
                            "rotate": [{"axis": [0, 1, 0],
                                        "angle": 0.7}]}]}],
    }))
    return str(path)


@pytest.mark.parametrize("refit", [False, True])
def test_cli_animate_writes_frames(anim_file, tmp_path, monkeypatch, capsys,
                                   refit):
    """`animate` through the parser (the production configuration), then
    cmd_animate on the CPU: one PNG a frame, the frames differ."""
    import fspt_tpu_torch.__main__ as cli
    from fspt_tpu_torch.io.image import read_png
    seen = []
    monkeypatch.setattr(cli, "cmd_animate", lambda args: seen.append(args))
    out_dir = str(tmp_path / "frames")
    cli.main(["animate", anim_file, "--end", "2", "-o", out_dir, "--res",
              "16", "--bounces", "1", "--batch-spp", "1", "--samples", "1"]
             + (["--refit"] if refit else []))
    args, = seen
    assert (args.start, args.end, args.out_dir, args.refit) == (
        0, 2, out_dir, refit)
    assert cli._config(args).intersector == "split"
    monkeypatch.undo()
    assert cli.cmd_animate(args, device="cpu") == 0
    paths = capsys.readouterr().out.split()
    assert [os.path.basename(p) for p in paths] == ["frame_00000.png",
                                                    "frame_00001.png"]
    a, b = (read_png(p) for p in paths)
    assert a.shape == (16, 16, 3) and a.max() > 0
    assert not np.array_equal(a, b)
