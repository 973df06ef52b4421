"""Interactive live viewer (reference src/Viewer.cc:70-190).

Port of `ceres_mono_orb_slam2_tpu/live_viewer.py`. The reference runs a
Pangolin window: a menu panel (Follow Camera / Show Points / Show KeyFrames
/ Show Graph / Localization Mode / Reset, Viewer.cc:85-91) beside the map
view, and an OpenCV window with the FrameDrawer output, refreshed every
T = 1000 / fps ms (Viewer.cc:43-52,166-168).

Without a display the equivalent is an HTTP app on the standard library's
ThreadingHTTPServer: an auto-refreshing page with the map and frame renders
of `viewer.py` and the same menu, wired to the `MonoSLAM` entry points the
Pangolin callbacks reach (activate / deactivate localization mode,
Viewer.cc:132-139; reset with its menu-restoring block, Viewer.cc:153-164).
The `viewer-render` thread plays Viewer::Run's loop: it copies the tracker's
and the map's state under the map lock and rasterises outside it; the
`viewer-http` thread serves.

Endpoints:
  GET  /            menu + images page (auto-refresh)
  GET  /frame.png   latest FrameDrawer render
  GET  /map.png     latest MapDrawer render
  GET  /state.json  tracking state + menu state (programmatic clients, tests)
  POST /menu        urlencoded menu update (follow / points / keyframes /
                    graph / localization checkboxes, reset button)
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ceres_mono_orb_slam2_tpu_torch.models.system import JOIN_TIMEOUT_S
from ceres_mono_orb_slam2_tpu_torch.viewer import Viewer

log = logging.getLogger(__name__)

_PAGE = """<!doctype html>
<html><head><title>ceres_mono_orb_slam2_tpu_torch: Map Viewer</title>
<style>
 body { font-family: sans-serif; margin: 0; display: flex; }
 #menu { width: 185px; padding: 10px; background: #f0f0f0; }
 #menu label { display: block; margin: 6px 0; font-size: 13px; }
 #views { flex: 1; padding: 8px; }
 img { max-width: 100%%; display: block; margin-bottom: 8px; }
</style></head>
<body>
<div id="menu">
<form method="POST" action="/menu">
<label><input type="checkbox" name="follow" %(follow)s> Follow Camera</label>
<label><input type="checkbox" name="points" %(points)s> Show Points</label>
<label><input type="checkbox" name="keyframes" %(keyframes)s> Show KeyFrames</label>
<label><input type="checkbox" name="graph" %(graph)s> Show Graph</label>
<label><input type="checkbox" name="localization" %(localization)s> Localization Mode</label>
<button type="submit" name="apply" value="1">Apply</button>
<button type="submit" name="reset" value="1">Reset</button>
</form>
<p id="status" style="font-size:12px"></p>
</div>
<div id="views">
 <img id="frame" src="/frame.png">
 <img id="map" src="/map.png">
</div>
<script>
 setInterval(function() {
   var t = Date.now();
   document.getElementById('frame').src = '/frame.png?' + t;
   document.getElementById('map').src = '/map.png?' + t;
   fetch('/state.json').then(r => r.json()).then(s => {
     document.getElementById('status').textContent =
       s.state + ' | frame ' + s.frame + ' | KFs ' + s.n_keyframes +
       ' | MPs ' + s.n_map_points;
   });
 }, %(period_ms)d);
</script>
</body></html>
"""

# 1x1 gray PNG shown before the first render lands
PLACEHOLDER = bytes.fromhex(
    "89504e470d0a1a0a0000000d4948445200000001000000010802000000907753de"
    "0000000c4944415408d763a8a9a90100029d0166e8305c2d0000000049454e44ae426082"
)
# Pangolin menu defaults (Viewer.cc:85-91)
MENU_DEFAULTS = {"follow": False, "points": True, "keyframes": True, "graph": True,
                 "localization": False}


class LiveViewer:
    """Threaded HTTP viewer attached to a live `MonoSLAM`. `n_renders`
    counts the renders made, `n_render_errors` the renders that raised
    (logged; the server keeps running)."""

    def __init__(self, slam, port: int = 0, fps: float | None = None):
        self.slam = slam
        # the renderer; the live viewer keeps its own cadence
        self.renderer = Viewer(slam.config, slam.map, slam.tracker, every=1 << 30)
        f = fps if fps is not None else getattr(slam.config.camera, "fps", 30.0) or 30.0
        self.period_s = 1.0 / max(float(f), 1.0)  # Viewer.cc:43-52 (T_)
        self.menu_lock = threading.Lock()
        self.menu = dict(MENU_DEFAULTS)
        self._frame_png = PLACEHOLDER
        self._map_png = PLACEHOLDER
        self._last_frame_id = -1
        self.n_renders = 0
        self.n_render_errors = 0
        self._stop = threading.Event()
        self._server = ThreadingHTTPServer(("127.0.0.1", port), self._make_handler())
        self.port = self._server.server_address[1]
        self._http_thread = threading.Thread(target=self._server.serve_forever, name="viewer-http",
                                             daemon=True)
        self._render_thread = threading.Thread(target=self._run, name="viewer-render", daemon=True)

    def start(self):
        self._http_thread.start()
        self._render_thread.start()
        return self

    def shutdown(self):
        """Stop serving, close the socket and join both threads; also for a
        viewer never started, and a second call does nothing new. A render
        waiting on map.update_lock finishes first, so the join waits as long
        as `MonoSLAM.shutdown` waits for the mapper: a loop correction holds
        the lock for seconds."""
        self._stop.set()
        if self._http_thread.is_alive():
            self._server.shutdown()  # returns once serve_forever has
        self._server.server_close()
        for t in (self._http_thread, self._render_thread):
            if t.is_alive():
                t.join(timeout=JOIN_TIMEOUT_S)
                if t.is_alive():
                    raise RuntimeError(f"the {t.name} thread did not stop within {JOIN_TIMEOUT_S} s")

    # ------------------------------------------------------------ render loop

    def _run(self):
        """Viewer::Run: render whenever a new frame arrived, at most once a
        period (Viewer.cc:114-168)."""
        while not self._stop.wait(self.period_s):
            try:
                self._render_once()
            except Exception:  # a render failure must never stop the server
                self.n_render_errors += 1
                log.exception("live viewer render failed")

    def _render_once(self):
        f = self.slam.tracker.current
        if f is None or f.id == self._last_frame_id:
            return
        with self.menu_lock:
            menu = dict(self.menu)
        # fetch a lazy frame's keypoints from the device BEFORE taking the
        # map lock: holding it across the copy would stall the tracker
        f._materialize_host()
        # copy the state under the map lock, rasterise outside it (the
        # FrameDrawer::Update / DrawFrame split)
        with self.slam.map.update_lock:
            fg = self.renderer.frame_geometry()
            mg = self.renderer.map_geometry()
        buf = io.BytesIO()
        if self.renderer.draw_frame(buf, geom=fg) is not None:
            self._frame_png = buf.getvalue()
        buf = io.BytesIO()
        self.renderer.snapshot(buf, geom=mg, show_points=menu["points"],
                               show_keyframes=menu["keyframes"], show_graph=menu["graph"],
                               follow=menu["follow"])
        self._map_png = buf.getvalue()
        self._last_frame_id = fg["frame"] if fg["frame"] is not None else -1
        self.n_renders += 1

    # ------------------------------------------------------------- menu logic

    def apply_menu(self, form: dict):
        """Apply a menu POST with the reference's toggle semantics."""
        if "reset" in form:
            # Viewer.cc:153-164: restore the menu defaults, leave localization
            # mode, follow the camera, then System::Reset
            with self.menu_lock:
                self.menu.update(MENU_DEFAULTS, follow=True)
            self.slam.deactivate_localization_mode()
            self.slam.reset()
            return
        new = {k: (k in form) for k in MENU_DEFAULTS}
        with self.menu_lock:
            was_loc = self.menu["localization"]
            self.menu.update(new)
        # Viewer.cc:132-139: the localization switch acts on its edges
        if new["localization"] and not was_loc:
            self.slam.activate_localization_mode()
        elif not new["localization"] and was_loc:
            self.slam.deactivate_localization_mode()

    def state(self) -> dict:
        f = self.slam.tracker.current
        with self.menu_lock:
            menu = dict(self.menu)
        return {
            "frame": -1 if f is None else int(f.id),
            "state": self.slam.get_tracking_state(),
            "n_keyframes": self.slam.map.n_keyframes(),
            "n_map_points": self.slam.map.n_map_points(),
            "localization": self.slam.tracker.localization_only,
            "menu": menu,
        }

    # -------------------------------------------------------------- http app

    def _make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    with viewer.menu_lock:
                        m = dict(viewer.menu)
                    page = _PAGE % {**{k: ("checked" if v else "") for k, v in m.items()},
                                    "period_ms": max(int(viewer.period_s * 1000), 100)}
                    self._send(200, "text/html", page.encode())
                elif path == "/frame.png":
                    self._send(200, "image/png", viewer._frame_png)
                elif path == "/map.png":
                    self._send(200, "image/png", viewer._map_png)
                elif path == "/state.json":
                    self._send(200, "application/json", json.dumps(viewer.state()).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] != "/menu":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                viewer.apply_menu(parse_qs(self.rfile.read(n).decode()))
                # back to the menu page
                self.send_response(303)
                self.send_header("Location", "/")
                self.send_header("Content-Length", "0")
                self.end_headers()

        return Handler
