"""The port's interactive viewer (fspt_tpu_torch.runtime.viewer), the `view`
command, `Renderer.profile_trace`, and the card-only cases of refit and
animation.

tests/test_viewer.py's three tests on the port on the CPU (headless: the
viewer's event machine and render loop directly, then once more over real
HTTP on a loopback socket).  The `cuda` cases run on a card with
`pytest --noconftest -m cuda` and skip here.
"""

import glob
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.runtime.renderer import Renderer
from fspt_tpu_torch.runtime.viewer import (InteractiveViewer, _rotate_axis,
                                           _rotate_y)
from fspt_tpu_torch.testing import make_test_scene

torch.set_num_threads(1)


def _cfg():
    return RenderConfig(width=32, height=32, bounces=2,
                        extra_refraction_iters=1, batch_spp=1, seed=3)


@pytest.fixture(scope="module")
def small_scene():
    return make_test_scene(subdivisions=2)


@pytest.fixture(scope="module")
def viewer(small_scene):
    v = InteractiveViewer(small_scene, _cfg(), device="cpu")
    yield v
    v.stop()


def _wait_frame(v, last_id, timeout=120.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        png, meta, fid = v.frame_png()
        if fid != last_id and png:
            return png, meta, fid
        time.sleep(0.05)
    raise TimeoutError("no frame produced")


# ---- tests/test_viewer.py, on the port ------------------------------------

def test_rotations_are_rigid():
    v = np.array([0.3, -0.5, 0.8], np.float32)
    for out in (_rotate_y(v, 0.7),
                _rotate_axis(v, [0.2, 0.9, -0.1], -1.3)):
        assert np.isclose(np.linalg.norm(out), np.linalg.norm(v), atol=1e-5)
    assert np.allclose(_rotate_y(v, 0.0), v, atol=1e-7)


def test_viewer_loop_and_events(viewer):
    v = viewer.start()
    png, meta, fid = _wait_frame(v, -1)
    assert png[:4] == b"\x89PNG"

    # camera look: direction changes, accumulation restarts
    d0 = v.renderer.camera.direction.numpy().copy()
    v.handle_event({"type": "look", "dx": 40, "dy": 10})
    d1 = v.renderer.camera.direction.numpy()
    assert not np.allclose(d0, d1)
    assert np.isclose(np.linalg.norm(d1), 1.0, atol=1e-5)

    # while moving (a drag is a stream of events) the loop serves
    # quarter-res previews; keep the drag alive until one arrives
    got_preview = False
    deadline = time.time() + 120
    while time.time() < deadline:
        v.handle_event({"type": "look", "dx": 2, "dy": 0})
        png, meta, fid = _wait_frame(v, fid)
        if meta["preview"]:
            got_preview = True
            break
    assert got_preview
    d1 = v.renderer.camera.direction.numpy()

    # fly forward moves the position along the view direction
    p0 = v.renderer.camera.position.numpy()
    v.handle_event({"type": "fly", "w": 1, "speed": 0.1})
    p1 = v.renderer.camera.position.numpy()
    assert np.isclose(np.dot(p1 - p0, d1), 0.1, atol=1e-5)

    # zoom adjusts fovScale
    f0 = float(v.renderer.camera.fov_scale)
    v.handle_event({"type": "zoom", "delta": -200})
    assert float(v.renderer.camera.fov_scale) < f0

    # settle: after the debounce the loop returns to progressive frames
    # with a growing sample counter
    v.handle_event({"type": "moveend"})
    deadline = time.time() + 120
    while time.time() < deadline:
        png, meta, fid = _wait_frame(v, fid)
        if not meta["preview"] and meta["samples"] >= 2:
            break
    assert not meta["preview"] and meta["samples"] >= 2

    # tonemap-only sliders must NOT restart accumulation
    s0 = meta["samples"]
    v.handle_event({"type": "slider", "name": "exposure", "value": 2.0})
    assert v.renderer.post.exposure == 2.0
    png, meta, fid = _wait_frame(v, fid)
    assert meta["samples"] >= s0

    # envTheta is dirty: accumulation restarts
    v.handle_event({"type": "slider", "name": "envTheta", "value": 1.0})
    assert float(v.renderer.arrays.env_theta) == 1.0
    assert float(v.preview.arrays.env_theta) == 1.0


def test_viewer_http(small_scene):
    import socket
    import threading
    v = InteractiveViewer(small_scene, _cfg(), device="cpu")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t = threading.Thread(target=v.serve, kwargs=dict(port=port),
                         daemon=True)
    t.start()
    try:
        deadline = time.time() + 120
        page = None
        while time.time() < deadline:
            try:
                page = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/", timeout=5).read()
                break
            except OSError:
                time.sleep(0.2)
        assert page and b"fspt_tpu viewer" in page
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/input",
            data=json.dumps({"type": "zoom", "delta": 100}).encode(),
            method="POST")
        assert urllib.request.urlopen(req, timeout=10).status == 204
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame",
                                   timeout=60)
        assert r.headers["Content-Type"] == "image/png"
        assert json.loads(r.headers["X-Meta"])["samples"] >= 0
    finally:
        v.stop()
    assert not v._thread.is_alive()


# ---- the view command -------------------------------------------------------

@pytest.fixture
def scene_file(tmp_path):
    from fspt_tpu_torch.testing import icosphere_obj
    (tmp_path / "mesh.obj").write_text(icosphere_obj(0))
    path = tmp_path / "s.json"
    path.write_text(json.dumps({
        "environment": [[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]],
        "cameraPos": [0.0, 0.0, 3.0], "cameraDir": [0.0, 0.0, -1.0],
        "props": [{"path": "mesh.obj", "diffuse": [1, 0, 0]}],
    }))
    return str(path)


def test_cli_view(scene_file, monkeypatch):
    """`view` through the parser (--port, --host, --autofocus, the
    production configuration), then cmd_view on the CPU with the server
    stubbed: the viewer's renderer and preview both take the autofocus."""
    import fspt_tpu_torch.__main__ as cli
    seen = []
    monkeypatch.setattr(cli, "cmd_view", lambda args: seen.append(args))
    cli.main(["view", scene_file, "--port", "9123", "--host", "0.0.0.0",
              "--autofocus", "--res", "16", "--bounces", "1"])
    args, = seen
    assert (args.port, args.host, args.autofocus) == (9123, "0.0.0.0", True)
    monkeypatch.undo()
    served = []
    monkeypatch.setattr(InteractiveViewer, "serve",
                        lambda self, port, host: served.append(
                            (self, port, host)))
    assert cli.cmd_view(args, device="cpu") == 0
    (v, port, host), = served
    assert (port, host) == (9123, "0.0.0.0")
    assert v.renderer.cfg.intersector == "split" and v.renderer.cfg.compact
    # an icosahedron of circumradius 1 (inradius 0.795) at the origin seen
    # from z = 3: the view centre hits it at 2 <= t <= 2.205
    assert 2.0 <= float(v.renderer.camera.focal_depth) <= 2.21
    assert v.preview.camera is v.renderer.camera


# ---- Renderer.profile_trace -------------------------------------------------

def test_profile_trace_writes_chrome_trace(small_scene, tmp_path):
    r = Renderer(small_scene, RenderConfig(
        width=16, height=16, bounces=1, extra_refraction_iters=0,
        batch_spp=1), device="cpu")
    assert r.profile_trace(str(tmp_path), num_batches=1) is r
    assert float(r.count) == 1.0
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    step, = [e for e in events if e.get("name") == "fspt.step"]
    assert not [e for e in events if e.get("name") == "Renderer.step"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
    assert len(ops) > 100
    assert any(e["name"].startswith("aten::") for e in ops)


# ---- on the card -----------------------------------------------------------

@pytest.mark.cuda
def test_cuda_refit_matches_cpu():
    """refit_arrays on the card against the CPU's on the same base scene
    and affines: geometry, boxes and packed tables within atol 1e-6, the
    light CDF and area within rtol 1e-6, integer fields equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fspt_tpu_torch.scene.refit import build_refit_aux, refit_arrays
    from fspt_tpu_torch.scene.schema import SceneArrays
    scene = make_test_scene(subdivisions=2, emissive_sphere=True)
    aux = build_refit_aux(scene)
    rot = np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]])
    P = scene.build["n_props"]
    mats = np.tile((0.9 * rot).astype(np.float32), (P, 1, 1))
    trans = np.tile(np.float32([0.2, 0.1, -0.3]), (P, 1))
    cpu = refit_arrays(scene.to_torch("cpu"), scene.meta, aux, mats, trans)
    gpu = refit_arrays(scene.to_torch("cuda"), scene.meta, aux, mats, trans)
    assert gpu.pk_nodes.is_cuda
    for field in SceneArrays._fields:
        a, b = getattr(gpu, field), getattr(cpu, field)
        a = torch.stack(tuple(a)) if isinstance(a, tuple) else a
        b = torch.stack(tuple(b)) if isinstance(b, tuple) else b
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if not a.is_floating_point():
            assert torch.equal(a, b), field
        elif field in ("light_cdf", "light_area"):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=field)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=field)


@pytest.mark.cuda
def test_cuda_animate_frame(tmp_path):
    """A refit animation (the base frame and one refit frame) on the card
    under the production configuration, through the kernel, within
    tests/test_refit.py's PNG bounds of the CPU's frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fspt_tpu_torch.io.image import read_png
    from fspt_tpu_torch.ops.traverse4 import packet_traverse4
    from fspt_tpu_torch.runtime.animation import render_animation
    from fspt_tpu_torch.testing import DictAssetLoader, icosphere_obj, quad_obj
    loader = DictAssetLoader(texts={"s.obj": icosphere_obj(2),
                                    "f.obj": quad_obj()})
    sd = {"environment": [[0.3, 0.3, 0.4], [0.9, 0.9, 1.0]],
          "cameraPos": [0, 0.4, 2.2], "cameraDir": [0, -0.18, -0.98],
          "props": [{"path": "f.obj", "scale": 6,
                     "translate": [0, -0.5, 0], "diffuse": [0.6, 0.6, 0.6]}],
          "animated_props": [
              {"path": "s.obj", "scale": 0.5, "diffuse": [0.9, 0.4, 0.3],
               "keyframes": [{"frame": 0, "translate": [-0.3, 0, 0]},
                             {"frame": 1, "translate": [0.3, 0.1, 0],
                              "rotate": [{"axis": [0, 1, 0],
                                          "angle": 0.6}]}]}]}
    cfg = RenderConfig(width=32, height=32, bounces=3,
                       extra_refraction_iters=0, batch_spp=2, seed=4,
                       compact=True, sort_state=True, intersector="split",
                       nee_env_nearest=True, escape_env_nearest=True)
    before = packet_traverse4.launches
    gpu = render_animation(sd, loader, str(tmp_path / "gpu"), range(2),
                           config=cfg, samples=2, refit=True, device="cuda")
    assert packet_traverse4.launches > before
    cpu = render_animation(sd, loader, str(tmp_path / "cpu"), range(2),
                           config=cfg, samples=2, refit=True, device="cpu")
    for pg, pc in zip(gpu, cpu):
        a, b = read_png(pg), read_png(pc)
        assert np.mean(np.abs(a - b)) < 2.0 / 255.0
        assert np.quantile(np.abs(a - b), 0.99) <= 4.0 / 255.0
