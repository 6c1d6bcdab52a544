"""Interactive viewer: fly the scene like the reference's browser page
(port of fspt_tpu.runtime.viewer, on one torch device).

Reference parity (main.js:619-739 initEvents, :838-857 tick):
  * mouse-drag look — yaw about world-Y plus pitch about the view-right
    axis (reference rotateY + rotateArbitrary, main.js:641-643)
  * wheel zoom (fovScale, main.js:662-665)
  * WASD + RF fly (main.js:698-729)
  * live controls: envTheta / focal depth / aperture restart accumulation
    ("dirty"), exposure / saturation / denoise / sigma only re-tonemap
  * quarter-res preview while the camera moves, full-res progressive
    refinement with a live sample counter once it settles (resScale,
    main.js:841)
  * autofocus when a camera move ends (shootAutoFocusRay on mouseup,
    main.js:660,728), by the renderer's device traversal.

The UI is a single self-contained HTML page served by a stdlib HTTP server:
the page posts input events and polls PNG frames; all rendering stays on
the device.  The render loop runs in a thread of its own; input events
arrive on the HTTP server's threads.  On the card the events' reads and
writes of camera tensors go through a CUDA stream of their own, so an event
never waits for the loop's queued kernels.
Run:  python -m fspt_tpu_torch view scenes/dungeon.json --port 8787
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from fspt_tpu_torch.config import PostConfig, RenderConfig
from fspt_tpu_torch.runtime.renderer import Renderer


def _rotate_y(v, a):
    c, s = np.cos(a), np.sin(a)
    x, y, z = v
    return np.array([c * x + s * z, y, -s * x + c * z], np.float32)


def _rotate_axis(v, axis, a):
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    c, s = np.cos(a), np.sin(a)
    return np.asarray(
        v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c),
        np.float32)


class InteractiveViewer:
    """Camera/controls state machine + progressive render loop; the HTTP
    layer below is a thin shim over handle_event()/frame_png()."""

    PREVIEW_SCALE = 0.25          # reference resScale while moving
    SETTLE_S = 0.35               # move -> settled debounce

    def __init__(self, scene, config: Optional[RenderConfig] = None,
                 post: Optional[PostConfig] = None, device="cuda"):
        self.scene = scene
        self.cfg = config or RenderConfig()
        self.renderer = Renderer(scene, self.cfg, post=post, device=device)
        self.device = self.renderer.device
        pw = max(int(self.cfg.width * self.PREVIEW_SCALE) // 8 * 8, 16)
        ph = max(int(self.cfg.height * self.PREVIEW_SCALE) // 8 * 8, 16)
        self.preview = Renderer(
            scene, dataclasses.replace(self.cfg, width=pw, height=ph,
                                       batch_spp=1),
            post=post, device=self.device)
        self._events = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.lock = threading.Lock()
        self.dirty = False
        self.last_move = 0.0
        self.needs_autofocus = False
        self._frame = b""
        self._frame_meta = {"samples": 0, "preview": True}
        self._frame_id = 0
        self.running = False
        self._thread = None

    # ---- camera tensors from the event threads -------------------------
    def _on_events(self):
        return (torch.cuda.stream(self._events) if self._events is not None
                else contextlib.nullcontext())

    def _host(self, t) -> np.ndarray:
        """A camera tensor's value.  Every camera tensor was complete when
        it was published (its copy was waited for), so the read waits for
        the events' stream alone."""
        with self._on_events():
            return t.cpu().numpy()

    def _put(self, x) -> torch.Tensor:
        """A new float32 tensor of `x` on the device, complete on return."""
        with self._on_events():
            t = torch.tensor(np.asarray(x, np.float32), device=self.device)
        if self._events is not None:
            # the loop's stream reads it: its memory is not reused before
            # that stream is past the reads
            t.record_stream(torch.cuda.default_stream(self.device))
        return t

    # ---- input events (reference initEvents) ---------------------------
    def handle_event(self, ev: dict):
        with self.lock:
            cam = self.renderer.camera
            pos = self._host(cam.position)
            d = self._host(cam.direction)
            kind = ev.get("type")
            if kind == "look":
                d = _rotate_y(d, -float(ev.get("dx", 0)) * 0.003)
                right = np.cross(d, [0.0, 1.0, 0.0])
                d = _rotate_axis(d, right, -float(ev.get("dy", 0)) * 0.003)
                d /= max(np.linalg.norm(d), 1e-12)
            elif kind == "zoom":
                f = float(self._host(cam.fov_scale)) * float(
                    np.exp(float(ev.get("delta", 0)) * 1e-3))
                cam = cam._replace(fov_scale=self._put(np.clip(f, 0.02, 4.0)))
            elif kind == "fly":
                right = np.cross(d, [0.0, 1.0, 0.0])
                right /= max(np.linalg.norm(right), 1e-12)
                step = float(ev.get("speed", 0.05))
                pos = (pos + d * step * float(ev.get("w", 0))
                       + right * step * float(ev.get("a", 0))
                       + np.array([0, 1, 0], np.float32) * step
                       * float(ev.get("r", 0)))
            elif kind == "slider":
                name, value = ev["name"], float(ev["value"])
                post = self.renderer.post
                if name == "envTheta":
                    theta = self._put(value)
                    self.renderer.arrays = self.renderer.arrays._replace(
                        env_theta=theta)
                    self.preview.arrays = self.preview.arrays._replace(
                        env_theta=theta)
                elif name == "focalDepth":
                    cam = cam._replace(focal_depth=self._put(value))
                elif name == "aperture":
                    cam = cam._replace(aperture=self._put(value))
                elif name in ("exposure", "saturation", "max_sigma"):
                    post = dataclasses.replace(post, **{name: value})
                elif name == "denoise":
                    post = dataclasses.replace(post, denoise=value > 0)
                self.renderer.post = post
                self.preview.post = post
                if name in ("exposure", "saturation", "max_sigma",
                            "denoise"):
                    # tonemap-only: re-encode the current accumulation
                    # without restarting it (reference slider semantics)
                    self._frame_id += 1
                    return
            elif kind == "moveend":
                self.needs_autofocus = True
                self.last_move = 0.0
                self.dirty = True
                return
            cam = cam._replace(position=self._put(pos),
                               direction=self._put(d))
            self.renderer.camera = cam
            self.preview.camera = cam
            self.dirty = True
            self.last_move = time.time()

    # ---- progressive loop (reference tick, main.js:838-857) ------------
    def _loop(self):
        while self.running:
            with self.lock:
                dirty = self.dirty
                self.dirty = False
                moving = (time.time() - self.last_move) < self.SETTLE_S
                autofocus = self.needs_autofocus and not moving
                self.needs_autofocus = self.needs_autofocus and not autofocus
            if autofocus:
                t = self.renderer.autofocus()
                with self.lock:
                    self.preview.camera = self.renderer.camera
                    if t < self.cfg.max_t:
                        dirty = True
            if dirty:
                self.renderer.reset()
            if moving:
                self.preview.reset()
                self.preview.step()
                self._publish(self.preview, preview=True)
            else:
                self.renderer.step()
                self._publish(self.renderer, preview=False)

    def _publish(self, r: Renderer, preview: bool):
        with self.lock:
            img = np.clip(r.image(), 0.0, 1.0)
            samples = int(float(r.count))
        from PIL import Image
        buf = io.BytesIO()
        im = Image.fromarray((img * 255.0 + 0.5).astype(np.uint8))
        if preview:
            im = im.resize((self.cfg.width, self.cfg.height),
                           Image.NEAREST)
        im.save(buf, "PNG")
        with self.lock:
            self._frame = buf.getvalue()
            self._frame_meta = {"samples": samples,
                                "preview": preview,
                                "rays_per_s": r.stats.get("rays_per_s", 0.0)}
            self._frame_id += 1

    def frame_png(self):
        with self.lock:
            return self._frame, dict(self._frame_meta), self._frame_id

    def start(self):
        # both renderers' graphs before the first event: an event that
        # lands during a capture would wait for it
        self.renderer.warm_up()
        self.preview.warm_up()
        self.running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=10)

    # ---- HTTP shim ------------------------------------------------------
    def serve(self, port: int = 8787, host: str = "127.0.0.1"):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/frame"):
                    png, meta, fid = viewer.frame_png()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("X-Meta", json.dumps(meta))
                    self.send_header("X-Frame-Id", str(fid))
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE.encode())

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                ev = json.loads(self.rfile.read(length) or b"{}")
                viewer.handle_event(ev)
                self.send_response(204)
                self.end_headers()

        self.start()
        server = ThreadingHTTPServer((host, port), Handler)
        print(f"viewer: http://{host}:{port}/  (drag=look, wheel=zoom, "
              "WASD+RF=fly)")
        try:
            server.serve_forever()
        finally:
            self.stop()


_PAGE = """<!doctype html><meta charset=utf-8><title>fspt_tpu viewer</title>
<style>body{margin:0;background:#111;color:#ccc;font:13px monospace;display:flex}
#img{image-rendering:pixelated;cursor:grab;touch-action:none}
#panel{padding:12px;min-width:230px}label{display:block;margin:8px 0 2px}
input[type=range]{width:210px}</style>
<img id=img draggable=false><div id=panel><div id=stat>connecting…</div>
<label>env theta <input type=range id=envTheta min=0 max=6.2832 step=0.01 value=0></label>
<label>exposure <input type=range id=exposure min=0.05 max=6 step=0.05 value=1></label>
<label>saturation <input type=range id=saturation min=0 max=2 step=0.05 value=1></label>
<label>focal depth <input type=range id=focalDepth min=0.1 max=20 step=0.05 value=5></label>
<label>aperture <input type=range id=aperture min=0 max=0.2 step=0.002 value=0></label>
<label>denoise <input type=checkbox id=denoise></label>
<p>drag = look · wheel = zoom<br>W/A/S/D fly · R/F up/down</p></div>
<script>
const img=document.getElementById('img'),stat=document.getElementById('stat');
const post=o=>fetch('/input',{method:'POST',body:JSON.stringify(o)});
let lastId=-1;
async function poll(){try{const r=await fetch('/frame?t='+Date.now());
 const id=r.headers.get('X-Frame-Id');const m=JSON.parse(r.headers.get('X-Meta')||'{}');
 if(id!==lastId){lastId=id;const b=await r.blob();img.src=URL.createObjectURL(b);
  stat.textContent=(m.preview?'preview':'samples: '+m.samples)+
   (m.rays_per_s?' · '+(m.rays_per_s/1e6).toFixed(1)+' Mrays/s':'');}}catch(e){}
 setTimeout(poll,100);}poll();
let drag=null;img.onpointerdown=e=>{drag=[e.clientX,e.clientY];img.setPointerCapture(e.pointerId)};
img.onpointermove=e=>{if(!drag)return;post({type:'look',dx:e.clientX-drag[0],dy:e.clientY-drag[1]});drag=[e.clientX,e.clientY];};
img.onpointerup=e=>{drag=null;post({type:'moveend'})};
img.onwheel=e=>{e.preventDefault();post({type:'zoom',delta:e.deltaY})};
const keys={};onkeydown=e=>keys[e.key.toLowerCase()]=1;onkeyup=e=>{keys[e.key.toLowerCase()]=0;post({type:'moveend'})};
setInterval(()=>{const w=(keys.w?1:0)-(keys.s?1:0),a=(keys.d?1:0)-(keys.a?1:0),r=(keys.r?1:0)-(keys.f?1:0);
 if(w||a||r)post({type:'fly',w,a,r,speed:0.06});},60);
for(const id of['envTheta','exposure','saturation','focalDepth','aperture'])
 document.getElementById(id).oninput=e=>post({type:'slider',name:id,value:+e.target.value});
document.getElementById('denoise').onchange=e=>post({type:'slider',name:'denoise',value:e.target.checked?1:0});
</script>"""
