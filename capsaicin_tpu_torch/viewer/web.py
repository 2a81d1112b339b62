"""Interactive browser viewer streaming frames rendered on the GPU: the
counterpart of the reference's Win32 + ImGui viewer (src/viewer/main.cpp,
gui_system.cpp) and of capsaicin_tpu/viewer/web.py. A small HTTP server
sends JPEG frames to a canvas; WASD/QE and mouse drags move the CameraRig
(viewer/input.py). The settings panel has the ImGui controls
(gui_system.cpp:69-91): the float knobs are Settings values, and output
mode, bounces, denoise, eaw5, gather and TAA switch RenderOptions variants
(session.use_options) with a background kick that builds the kernel
library (session.precompile_background). The overlay shows ms/frame, FPS
and a per-pass timings table that refreshes itself (gui_system.cpp:94-104).
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .input import CameraRig, _host

_PAGE = """<!DOCTYPE html>
<html><head><title>capsaicin-tpu (PyTorch/CUDA)</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0 }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px; font-size:12px }
#hud label { display:block; margin-top:4px }
#hud input[type=range] { width:110px; vertical-align:middle }
#hud select { background:#222; color:#ddd }
#timings { white-space:pre; color:#9c9 }
button { background:#333; color:#ddd; border:1px solid #555; margin-top:4px }
canvas { display:block; margin:auto; image-rendering:pixelated }
</style></head><body>
<div id="hud">capsaicin-tpu &middot; WASD/QE move &middot; drag to look<br>
<span id="stats"></span>
<div id="opts"></div>
<div id="knobs"></div>
<button id="tbtn">pass timings</button>
<label style="display:inline">live <input type="checkbox" id="tlive" checked></label>
<div id="timings"></div></div>
<canvas id="c"></canvas>
<script>
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
const keys = new Set();
let dragging = false, lastX = 0, lastY = 0, acc = {dx: 0, dy: 0};
window.addEventListener('keydown', e => keys.add(e.key.toLowerCase()));
window.addEventListener('keyup', e => keys.delete(e.key.toLowerCase()));
canvas.addEventListener('mousedown', e => { dragging = true; lastX = e.clientX; lastY = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (dragging) { acc.dx += e.clientX - lastX; acc.dy += e.clientY - lastY;
                  lastX = e.clientX; lastY = e.clientY; }
});
// settings panel (the ImGui knob set, gui_system.cpp:69-91)
const changed = {};         // float knobs (Settings)
const optChanged = {};      // option flips (RenderOptions variants)
fetch('/settings').then(r => r.json()).then(cfg => {
  const kdiv = document.getElementById('knobs');
  for (const [name, spec] of Object.entries(cfg.knobs)) {
    const label = document.createElement('label');
    label.textContent = name + ' ';
    const input = document.createElement('input');
    input.type = 'range';
    input.min = spec.min; input.max = spec.max; input.step = spec.step;
    input.value = spec.value;
    const val = document.createElement('span');
    val.textContent = spec.value;
    input.oninput = () => { changed[name] = parseFloat(input.value);
                           val.textContent = input.value; };
    label.appendChild(input); label.appendChild(val);
    kdiv.appendChild(label);
  }
  const odiv = document.getElementById('opts');
  // fit-to-window resize: defaults OFF when the server warmed the option
  // variants at the CLI resolution (a resize drops that work)
  const fitLabel = document.createElement('label');
  fitLabel.textContent = 'fit window ';
  const fitBox = document.createElement('input');
  fitBox.type = 'checkbox';
  fitBox.checked = !!cfg.fit_window;
  fitLabel.appendChild(fitBox);
  odiv.appendChild(fitLabel);
  window.fitBox = fitBox;
  // vsync frame-pacing cap (gui_system.h:22)
  const vsLabel = document.createElement('label');
  vsLabel.textContent = 'vsync ';
  const vsSel = document.createElement('select');
  for (const v of [0, 30, 60, 120]) {
    const o = document.createElement('option');
    o.value = v; o.textContent = v === 0 ? 'off' : v + ' fps';
    vsSel.appendChild(o);
  }
  vsSel.value = cfg.fps_cap || 0;
  vsLabel.appendChild(vsSel);
  odiv.appendChild(vsLabel);
  window.vsSel = vsSel;
  for (const [name, spec] of Object.entries(cfg.options)) {
    const label = document.createElement('label');
    label.textContent = name + ' ';
    let input;
    if (spec.choices) {                 // enum -> dropdown
      input = document.createElement('select');
      for (const [i, c] of spec.choices.entries()) {
        const o = document.createElement('option');
        o.value = i; o.textContent = c; input.appendChild(o);
      }
      input.value = spec.value;
      input.onchange = () => optChanged[name] = parseInt(input.value);
    } else if (spec.max !== undefined) {  // int -> number input
      input = document.createElement('input');
      input.type = 'number'; input.min = spec.min; input.max = spec.max;
      input.value = spec.value; input.style.width = '40px';
      input.onchange = () => optChanged[name] = parseInt(input.value);
    } else {                              // bool -> checkbox
      input = document.createElement('input');
      input.type = 'checkbox'; input.checked = spec.value;
      input.onchange = () => optChanged[name] = input.checked;
    }
    label.appendChild(input);
    odiv.appendChild(label);
  }
});
// per-pass timings table (gui_system.cpp:94-104 shows it continuously).
// Auto-refreshes every 10 s while 'live' is checked: each refresh renders
// three timed frames that do not advance the state, so it is bounded but
// not free. The button forces an immediate refresh.
let timingBusy = false;
async function refreshTimings(manual) {
  if (timingBusy) return;
  timingBusy = true;
  if (manual) document.getElementById('timings').textContent = 'measuring...';
  try {
    const r = await fetch('/timings');
    const t = await r.json();
    document.getElementById('timings').textContent =
      Object.entries(t).map(([k, v]) => `${k.padEnd(26)} ${(v * 1e3).toFixed(2)} ms`).join('\\n');
  } finally { timingBusy = false; }
}
document.getElementById('tbtn').onclick = () => refreshTimings(true);
let frameCount = 0;
setInterval(() => {
  // wait until frames are flowing
  if (document.getElementById('tlive').checked && frameCount > 3)
    refreshTimings(false);
}, 10000);
let lastW = 0, lastH = 0;
async function loop() {
  const input = {keys: [...keys], dx: acc.dx, dy: acc.dy,
                 settings: {...changed}, options: {...optChanged},
                 fps_cap: window.vsSel ? parseInt(window.vsSel.value) : 0};
  // window-resize refit (camera_system.cpp:10-17): ask the server to render
  // at the window size, snapped to multiples of 8 (only when 'fit window'
  // is checked — see the precompile note above)
  if (window.fitBox && window.fitBox.checked) {
    const w = Math.max(64, Math.floor(window.innerWidth / 8) * 8);
    const h = Math.max(64, Math.floor(window.innerHeight / 8) * 8);
    if (w !== lastW || h !== lastH) { input.resize = [w, h]; lastW = w; lastH = h; }
  } else { lastW = 0; lastH = 0; }
  for (const k in changed) delete changed[k];
  for (const k in optChanged) delete optChanged[k];
  acc.dx = 0; acc.dy = 0;
  const r = await fetch('/frame', {method: 'POST', body: JSON.stringify(input)});
  const stats = JSON.parse(r.headers.get('X-Stats'));
  frameCount = stats.frame;
  document.getElementById('stats').textContent =
      `${stats.ms.toFixed(1)} ms/frame  ${stats.fps.toFixed(1)} fps  frame ${stats.frame}`;
  const blob = await r.blob();
  const bmp = await createImageBitmap(blob);
  canvas.width = bmp.width; canvas.height = bmp.height;
  ctx.drawImage(bmp, 0, 0);
  requestAnimationFrame(loop);
}
loop();
</script></body></html>"""

# sliders of the float knobs; ranges follow the ImGui panel (gui_system.cpp:76-90)
_KNOBS = {
    "eaw_normal_sigma": (1.0, 256.0, 1.0),
    "eaw_depth_sigma": (0.1, 10.0, 0.1),
    "eaw_luma_sigma": (0.1, 10.0, 0.1),
    "gather_normal_sigma": (1.0, 256.0, 1.0),
    "gather_depth_sigma": (0.1, 10.0, 0.1),
    "gather_luma_sigma": (0.1, 10.0, 0.1),
    "temporal_upscale_feedback": (0.0, 1.0, 0.005),
    "taa_feedback": (0.0, 1.0, 0.005),
    "exposure": (0.01, 4.0, 0.01),
}

# RenderOptions the panel flips live (gui_system.cpp:69-91)
_OPTIONS = {
    "output": {"choices": ["Combined", "Direct", "Indirect", "Variance"]},
    "num_diffuse_bounces": {"min": 0, "max": 5},
    "denoise": {},
    "eaw5": {},
    "gather": {},
    "taa": {},
}


class ViewerState:
    def __init__(self, session):
        self.session = session
        self.rig = CameraRig.from_camera(session.camera)
        self.sensor_w = float(_host(session.camera.sensor_size)[0])
        self.focal = float(_host(session.camera.focal_length))
        self.aspect = session.height / session.width
        self.last_time = time.perf_counter()
        self.lock = threading.Lock()
        # vsync analog (gui_system.h:22): the frame interval the server
        # paces to; 0 = as fast as the client asks
        self.fps_cap = 0
        self._next_frame = 0.0

    def step(self, keys, dx, dy, settings_updates=None, option_updates=None, resize=None,
             fps_cap=None):
        """Apply one client request (keys, mouse, knobs, option flips,
        resize, vsync cap) and render a frame: (image, ms, moved)."""
        now = time.perf_counter()
        dt_ms = min((now - self.last_time) * 1e3, 100.0)
        self.last_time = now
        moved = bool(keys) or dx or dy
        if keys:
            self.rig.handle_keys(keys, dt_ms)
        if dx or dy:
            self.rig.handle_mouse(dx, dy, dt_ms)
        if resize:
            w, h = int(resize[0]), int(resize[1])
            self.session.resize(w, h)
            self.aspect = h / w
        if settings_updates:
            cur = self.session.settings._asdict()
            cur.update({k: float(np.float32(v)) for k, v in settings_updates.items()
                        if k in cur})
            self.session.settings = type(self.session.settings)(**cur)
        if option_updates:
            names = {f.name for f in dataclasses.fields(self.session.options)}
            valid = {k: v for k, v in option_updates.items() if k in names}
            if valid:
                self.session.use_options(dataclasses.replace(self.session.options, **valid))
                self.session.precompile_background()
        if fps_cap is not None:
            self.fps_cap = max(int(fps_cap), 0)
        camera = self.rig.to_camera(self.focal, self.sensor_w, self.aspect,
                                    device=self.session.device)
        t0 = time.perf_counter()
        img = self.session.render(camera)
        ms = (time.perf_counter() - t0) * 1e3
        # frame pacing: hold the response until the vsync interval has
        # passed (the DXGI present interval, gui_system.h:22)
        if self.fps_cap > 0:
            now2 = time.perf_counter()
            if now2 < self._next_frame:
                time.sleep(self._next_frame - now2)
            self._next_frame = max(self._next_frame, now2) + 1.0 / self.fps_cap
        else:
            self._next_frame = time.perf_counter()
        return img, ms, moved


def _encode_jpeg(img: np.ndarray) -> bytes:
    from PIL import Image

    # framebuffer row 0 is sensor -v; flip for display (see session.save_png)
    arr = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)[::-1]
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def serve(session, port: int = 8089, host: str = "127.0.0.1", precompile: bool = False):
    """Serve the interactive viewer until interrupted. precompile=True runs
    a frame of every panel variant before the server binds, so that no
    first flip hitches."""
    if precompile and session.shade is not None:
        print(f"precompiled {session.precompile_variants()} render variants")
    state = ViewerState(session)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, content_type: str, headers=()):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/settings"):
                cur = state.session.settings._asdict()
                knobs = {name: {"min": lo, "max": hi, "step": st, "value": float(cur[name])}
                         for name, (lo, hi, st) in _KNOBS.items() if name in cur}
                opts = {name: dict(spec, value=getattr(state.session.options, name))
                        for name, spec in _OPTIONS.items()}
                body = {"knobs": knobs, "options": opts, "fit_window": not precompile,
                        "fps_cap": state.fps_cap}
                self._send(json.dumps(body).encode(), "application/json")
            elif self.path.startswith("/timings"):
                with state.lock:
                    t = state.session.measure_pass_timings(iters=2)
                self._send(json.dumps(t).encode(), "application/json")
            else:
                self._send(_PAGE.encode(), "text/html")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                payload = {}
            with state.lock:
                img, ms, _ = state.step(
                    payload.get("keys", []), float(payload.get("dx", 0)),
                    float(payload.get("dy", 0)), payload.get("settings") or None,
                    payload.get("options") or None, payload.get("resize"),
                    payload.get("fps_cap"))
                frame = int(state.session.state.frame_count)
            stats = {"ms": ms, "fps": 1000.0 / max(ms, 1e-3), "frame": frame}
            self._send(_encode_jpeg(img), "image/jpeg", [("X-Stats", json.dumps(stats))])

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"viewer at http://{host}:{port} (ctrl-c to stop)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
