"""Interactive frame viewer: an HTTP server over a fitted or decoded
model (port of gsvc_tpu/viewer.py).

    from gsvc_tpu_torch.viewer import ViewerServer
    ViewerServer(state, cfg, settings, window_cap, frame_zs,
                 x_min, y_min, scale).serve(port=8765)

Frames render on the state's device through ``report._make_eval_render``
(``GSVC_DECODE`` and ``GSVC_RASTERIZER`` choose the path, as in
``evaluate_video``), are PNG-encoded on the host and cached by index.
``/`` serves a scrub-bar page, ``/frame/<i>`` a frame, ``/info`` the frame
count.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>gsvc-tpu viewer</title></head>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>gsvc-tpu viewer</h3>
<img id="f" style="max-width:100%%"/><br/>
<input id="s" type="range" min="0" max="%d" value="0" style="width:60%%"/>
<span id="l"></span>
<script>
const s=document.getElementById('s'),f=document.getElementById('f'),
      l=document.getElementById('l');
function u(){f.src='/frame/'+s.value+'?'+Date.now();l.textContent=s.value;}
s.oninput=u; u();
</script></body></html>"""


class ViewerServer:
    def __init__(self, state, cfg, settings, window_cap, frame_zs,
                 x_min, y_min, scale, decoded=False):
        from gsvc_tpu_torch.models.gaussians import GenerateMode
        from gsvc_tpu_torch.report import _make_eval_render

        mode = GenerateMode.DECODED if decoded \
            else GenerateMode.FULL_PRECISION
        self._render = _make_eval_render(cfg, settings, window_cap, x_min,
                                         y_min, scale, mode, decoded)
        self._state = state
        self._frame_zs = np.asarray(frame_zs)
        self._cache = {}
        self._lock = threading.Lock()

    def render_png(self, idx: int) -> bytes:
        """PNG bytes of frame ``idx`` (clamped to the frame range)."""
        from PIL import Image

        idx = int(np.clip(idx, 0, len(self._frame_zs) - 1))
        with self._lock:
            if idx not in self._cache:
                img = self._render(self._state, float(self._frame_zs[idx]))
                arr = np.clip(img.permute(1, 2, 0).cpu().numpy() * 255,
                              0, 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="PNG")
                self._cache[idx] = buf.getvalue()
            return self._cache[idx]

    def serve(self, port: int = 8765, background: bool = False):
        """Serve on ``port`` (0: any free port); with ``background`` in a
        daemon thread, returning the server (``shutdown()`` stops it)."""
        viewer = self
        n = len(self._frame_zs)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    if self.path.startswith("/frame/"):
                        idx = int(self.path.split("/")[2].split("?")[0])
                        data = viewer.render_png(idx)
                        self.send_response(200)
                        self.send_header("Content-Type", "image/png")
                        self.end_headers()
                        self.wfile.write(data)
                    elif self.path.startswith("/info"):
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                        self.end_headers()
                        self.wfile.write(json.dumps(
                            {"num_frames": n}).encode())
                    else:
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.end_headers()
                        self.wfile.write((_PAGE % (n - 1)).encode())
                except Exception as e:  # noqa: BLE001
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(str(e).encode())

        server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        if background:
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            return server
        server.serve_forever()
