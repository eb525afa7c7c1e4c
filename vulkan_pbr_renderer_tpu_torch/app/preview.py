"""Interactive preview client — the live-window counterpart of main.cpp (and
of vulkan_pbr_renderer_tpu/app/preview.py).

The reference's primary UX is a Win32 window with a FIFO swapchain, polled
key/mouse events, and live shader hot-reload (main.cpp:53-101,
fire_os_window.h).  A headless GPU host has no display server, so the window
becomes a tiny stdlib HTTP server: a browser page shows the latest frame and
forwards key/mouse events back; the render loop consumes them through the
same InputFrame -> camera_controls/debug_controls path the reference's loop
uses (camera.h:39-92, main.cpp:72-79).  Shader hot-reload (app/hotreload.py)
runs in the loop exactly like HotreloadShaders (main.cpp:81).

Run:  python -m vulkan_pbr_renderer_tpu_torch.app.preview --scene cube --port 8631
then open http://localhost:8631 (WASD+QE move, right-drag look, Shift/Ctrl
speed, 7/8/9/0 sun, G lightgrid view, Esc quits).  Frames render on the card;
--device cpu asks for the CPU.  The loop thread alone touches tensors: only
encoded bytes cross to the HTTP threads.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..config import RenderConfig
from ..utils import image as imglib
from . import key_input as ki

_PAGE = """<!doctype html>
<html><head><title>vulkan-pbr-renderer-tpu preview</title><style>
body { margin:0; background:#111; color:#ccc; font:12px monospace; }
img { display:block; margin:0 auto; image-rendering:pixelated; outline:none; }
#hud { position:fixed; left:8px; top:8px; }
</style></head><body>
<div id="hud">connecting...</div><img id="view" tabindex="0">
<script>
const view = document.getElementById('view'), hud = document.getElementById('hud');
let seq = 0, dragging = false, evs = [];
function post() { if (!evs.length) return; const b = JSON.stringify(evs); evs = [];
  fetch('/input', {method:'POST', body:b}); }
addEventListener('keydown', e => { if (!e.repeat) evs.push(['press', e.code]);
  else evs.push(['repeat', e.code]); e.preventDefault(); });
addEventListener('keyup', e => { evs.push(['release', e.code]); e.preventDefault(); });
view.addEventListener('mousedown', e => { dragging = (e.button === 2);
  if (dragging) evs.push(['press', 'MouseRight']); });
addEventListener('mouseup', e => { if (e.button === 2 && dragging) {
  dragging = false; evs.push(['release', 'MouseRight']); } });
addEventListener('mousemove', e => { if (dragging)
  evs.push(['mouse', e.movementX, e.movementY]); });
view.addEventListener('contextmenu', e => e.preventDefault());
setInterval(post, 33);
function tick() {
  const img = new Image();
  img.onload = () => { view.src = img.src; requestAnimationFrame(tick); };
  img.onerror = () => setTimeout(tick, 250);
  img.src = '/frame.png?' + (seq++);
}
tick();
setInterval(async () => { try { const r = await fetch('/stats');
  hud.textContent = await r.text(); } catch (e) {} }, 500);
</script></body></html>"""

# browser KeyboardEvent.code -> key_input.Key codes
_CODE_MAP = {
    "Space": ki.Key.SPACE, "Escape": ki.Key.ESCAPE, "Enter": ki.Key.ENTER,
    "Tab": ki.Key.TAB, "ShiftLeft": ki.Key.LEFT_SHIFT,
    "ShiftRight": ki.Key.RIGHT_SHIFT, "ControlLeft": ki.Key.LEFT_CONTROL,
    "ControlRight": ki.Key.RIGHT_CONTROL, "AltLeft": ki.Key.LEFT_ALT,
    "AltRight": ki.Key.RIGHT_ALT, "MouseRight": ki.Key.MOUSE_RIGHT,
    "ArrowLeft": ki.Key.LEFT, "ArrowRight": ki.Key.RIGHT,
    "ArrowUp": ki.Key.UP, "ArrowDown": ki.Key.DOWN,
}


def _key_from_code(code: str):
    if code in _CODE_MAP:
        return _CODE_MAP[code]
    if code.startswith("Key") and len(code) == 4:      # KeyA..KeyZ
        return ord(code[3])
    if code.startswith("Digit") and len(code) == 6:    # Digit0..Digit9
        return ord(code[5])
    return None


def _to_host(img):
    """[H,W,3] numpy array of a render step's frame; a tensor's copy to the
    host waits for the frame."""
    if isinstance(img, torch.Tensor):
        return img.cpu().numpy()
    return np.asarray(img)


class PreviewSession:
    """Owns the input frame + camera + render loop state.  The render step is
    injected (any (camera_state, sun_angle, visualize) -> [H,W,3] float
    tensor or array callable), so tests can drive the session without a
    renderer.  The camera's matrices are made on `device` (the card unless
    the caller asks for the CPU; raises without one)."""

    def __init__(self, render_step, cfg: RenderConfig, start_pos=(0.0, -6.0, 2.5),
                 sun_angle=(35.0, 80.0), on_tick=None, device="cuda"):
        from ..device import resolve_device
        from .camera import FpsCamera

        self.render_step = render_step
        self.cfg = cfg
        self.device = resolve_device(device)
        self.camera = FpsCamera(pos=np.asarray(start_pos, np.float32))
        self.inputs = ki.InputFrame()
        self.sun_angle = tuple(sun_angle)
        self.visualize_lightgrid = False
        self.on_tick = on_tick
        self.quit = False
        # live-stream frames ride JPEG when PIL is present (much cheaper than
        # the stdlib zlib PNG); file outputs stay PNG
        self.frame_png, self.frame_mime = imglib.encode_jpeg(
            np.zeros((cfg.height, cfg.width, 3), np.float32))
        self.frame_ms = 0.0
        self.frame_count = 0
        self._lock = threading.Lock()
        self._prev_t = None

    # -- input (called from HTTP threads) -----------------------------------

    def push_events(self, events):
        with self._lock:
            for ev in events:
                kind = ev[0]
                if kind == "mouse":
                    self.inputs.add_mouse_move(float(ev[1]), float(ev[2]))
                    continue
                key = _key_from_code(str(ev[1]))
                if key is None:
                    continue
                if kind == "press":
                    self.inputs.add_press(key)
                elif kind == "repeat":
                    self.inputs.add_press(key, repeat=True)
                elif kind == "release":
                    self.inputs.add_release(key)

    # -- one iteration of the reference's main loop (main.cpp:58-101) -------

    def tick(self):
        t = time.perf_counter()
        dt = min(t - self._prev_t, 0.1) if self._prev_t else 1.0 / 60.0
        self._prev_t = t

        with self._lock:
            frame = self.inputs
            self.sun_angle, self.visualize_lightgrid, self.quit = (
                ki.debug_controls(frame, self.sun_angle,
                                  self.visualize_lightgrid))
            cam_kw = ki.camera_controls(frame)
            frame.reset()
        self.camera.update(dt, speed=5.0, mouse_speed=0.001, **cam_kw)
        if self.on_tick:
            self.on_tick(self)

        img = self.render_step(self.camera.matrices(self.cfg, device=self.device),
                               self.sun_angle, self.visualize_lightgrid)
        png, mime = imglib.encode_jpeg(_to_host(img))
        self.frame_ms = (time.perf_counter() - t) * 1000.0
        with self._lock:
            self.frame_png = png
            self.frame_mime = mime
            self.frame_count += 1

    def loop(self):
        while not self.quit:
            self.tick()

    def stats(self):
        p = self.camera.pos
        return (f"frame {self.frame_count}  {self.frame_ms:.0f} ms  "
                f"pos ({p[0]:.1f}, {p[1]:.1f}, {p[2]:.1f})  "
                f"sun ({self.sun_angle[0]:.1f}, {self.sun_angle[1]:.1f})"
                + ("  [lightgrid]" if self.visualize_lightgrid else ""))


def make_handler(session: PreviewSession):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif path == "/frame.png":
                # endpoint name is historical; the payload is JPEG when PIL
                # is available (the mime header tells the browser)
                with session._lock:
                    png, mime = session.frame_png, session.frame_mime
                self._send(200, mime, png)
            elif path == "/stats":
                self._send(200, "text/plain", session.stats().encode())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path.split("?")[0] != "/input":
                self._send(404, "text/plain", b"not found")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                events = json.loads(self.rfile.read(n) or b"[]")
                session.push_events(events)
                self._send(200, "text/plain", b"ok")
            except (ValueError, KeyError, IndexError) as e:
                self._send(400, "text/plain", str(e).encode())

    return Handler


def serve(session: PreviewSession, port: int, run_loop=True):
    """Start the HTTP server (daemon thread) and, if run_loop, block in the
    render loop until Esc.  Returns the server for tests to shut down."""
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(session))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    if run_loop:
        try:
            session.loop()
        finally:
            server.shutdown()
    return server


def renderer_step(r):
    """The render step over a Renderer: r.render, or with `visualize` the
    same frame under cfg.visualize_lightgrid (render_frame updates r.state in
    place and returns the image)."""
    from . import renderer as renderer_mod

    def render_step(cam, sun_angle, visualize):
        if visualize:
            c = r.cfg.replace(visualize_lightgrid=True)
            return renderer_mod.render_frame(
                r.scene, r.state, cam, sun_angle, r.prefiltered_env, r.brdf_lut,
                c, r.raster_backend)
        return r.render(cam, sun_angle=sun_angle)

    return render_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cube")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--detail", type=float, default=1.0)
    ap.add_argument("--texture-size", type=int, default=128)
    ap.add_argument("--port", type=int, default=8631)
    ap.add_argument("--raster", default="auto")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--hot-reload", action="store_true",
                    help="reload shade/ modules on change (main.cpp:81)")
    args = ap.parse_args(argv)

    from ..device import init_devices
    from .headless import build_scene_by_name
    from .renderer import Renderer

    dev = init_devices(device=args.device)  # retries transient init failures
    cfg = RenderConfig(width=args.width, height=args.height)
    scene = build_scene_by_name(args.scene, detail=args.detail,
                                texture_size=args.texture_size, device=dev)
    r = Renderer(cfg, scene, device=dev, raster_backend=args.raster)

    watcher = None
    if args.hot_reload:
        from .hotreload import ShaderWatcher

        watcher = ShaderWatcher()

    def on_tick(s):
        if watcher is not None:
            watcher.poll()

    session = PreviewSession(renderer_step(r), cfg, on_tick=on_tick, device=dev)
    print(f"preview: http://localhost:{args.port}  (Esc to quit)")
    serve(session, args.port)


if __name__ == "__main__":
    main()
