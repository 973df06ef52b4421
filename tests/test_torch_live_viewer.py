"""The port's live viewer (`live_viewer.py`) on the CPU, a port of
`tests/test_live_viewer.py` against `MonoSLAM(device="cpu",
live_viewer_port=0)`: the page, the renders, the state endpoint and the
menu actions wired to the live system (localization toggle, reset), with
the same assertions; the renders decode to their sizes, none failed, and no
`viewer-*` thread outlives `shutdown()`. A threaded `shutdown()` that
arrives while a render waits seconds on the map lock still joins every
thread. Then the menu logic against the JAX package's `LiveViewer` on one
stub system. About 25 s alone on two threads."""

import collections
import json
import threading
import time
import types
import urllib.request

import torch

from ceres_mono_orb_slam2_tpu.live_viewer import LiveViewer as JaxLiveViewer
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch import viewer as V
from ceres_mono_orb_slam2_tpu_torch.live_viewer import PLACEHOLDER, LiveViewer
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.utils import png
from ceres_mono_orb_slam2_tpu_torch.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes

torch.set_num_threads(2)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _post_menu(port, data: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/menu", data=data, method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def _viewer_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("viewer-") and t.is_alive()]


def _config():
    return SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=1500),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096),
    )


def test_live_viewer_menu_and_renders():
    seq = make_sequence(n_frames=6, motion="strafe", step=0.12, seed=11)
    slam = MonoSLAM(_config(), device="cpu", live_viewer_port=0)
    lv = slam.live_viewer
    try:
        port = lv.port
        assert sorted(_viewer_threads()) == ["viewer-http", "viewer-render"]
        for k in range(6):
            slam.track_monocular(seq.images[k], seq.timestamps[k])

        # menu page with all Pangolin panel entries (Viewer.cc:85-91)
        status, ctype, body = _get(port, "/")
        assert status == 200 and "text/html" in ctype
        for item in ("Follow Camera", "Show Points", "Show KeyFrames",
                     "Show Graph", "Localization Mode", "Reset"):
            assert item in body.decode()

        # wait for the render thread to produce the last frame's image
        deadline = time.time() + 30
        while time.time() < deadline:
            _, _, png_bytes = _get(port, "/frame.png")
            if len(png_bytes) > 10_000 and lv._last_frame_id == slam.tracker.current.id:
                break
            time.sleep(0.2)
        assert len(png_bytes) > 10_000 and png_bytes[:8] == b"\x89PNG\r\n\x1a\n"
        assert png_bytes != PLACEHOLDER
        assert png.decode(png_bytes).shape == (480 + V.BAR_H, 640, 3)
        _, _, mpng = _get(port, "/map.png")
        assert mpng[:8] == b"\x89PNG\r\n\x1a\n" and png.decode(mpng).shape == (V.MAP_H, V.MAP_W, 3)

        status, _, body = _get(port, "/state.json")
        st = json.loads(body)
        assert st["state"] == "OK" and st["n_keyframes"] >= 2

        # localization toggle drives ActivateLocalizationMode (Viewer.cc:132)
        assert _post_menu(port, b"localization=on&points=on&keyframes=on&graph=on") == 200  # urllib follows the 303
        assert slam.tracker.localization_only is True
        # un-checking drives DeactivateLocalizationMode (Viewer.cc:136)
        assert _post_menu(port, b"points=on&keyframes=on&graph=on") == 200
        assert slam.tracker.localization_only is False

        # reset restores menu defaults + System::Reset (Viewer.cc:153-164)
        assert _post_menu(port, b"reset=1") == 200
        assert slam.map.n_keyframes() == 0
        st = json.loads(_get(port, "/state.json")[2])
        assert st["menu"] == {"follow": True, "points": True, "keyframes": True,
                              "graph": True, "localization": False}

        # system keeps tracking after a menu-driven reset (re-initializes)
        for k in range(6):
            slam.track_monocular(seq.images[k], seq.timestamps[k])
        assert slam.map.n_keyframes() >= 2
    finally:
        slam.shutdown()
    # shutdown stops the server and both threads; no render failed
    try:
        _get(port, "/state.json")
        served_after = True
    except Exception:
        served_after = False
    assert not served_after
    assert _viewer_threads() == []
    assert lv.n_renders > 0 and lv.n_render_errors == 0


def test_shutdown_waits_for_a_render_behind_the_map_lock():
    """Threaded: `shutdown()` arrives while the render thread waits on
    map.update_lock, which another thread holds for longer than a loop
    correction holds it (seconds). The render finishes once the lock is
    free, and the rest of the shutdown runs: the viewer and the mapper
    threads are joined, and nothing is counted as a render error."""
    hold_s = 6.5
    seq = make_sequence(n_frames=1, motion="strafe", step=0.12, seed=11)
    slam = MonoSLAM(_config(), device="cpu", threaded=True, live_viewer_port=0)
    lv = slam.live_viewer
    locked, waiting, release = threading.Event(), threading.Event(), threading.Event()

    def hold():
        with slam.map.update_lock:
            locked.set()
            release.wait(60)

    holder = threading.Thread(target=hold, name="holder")
    try:
        slam.track_monocular(seq.images[0], seq.timestamps[0])
        deadline = time.time() + 30
        while lv.n_renders < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert lv.n_renders == 1
        holder.start()
        assert locked.wait(10)
        f = slam.tracker.current
        materialize = f._materialize_host

        def materialize_then_lock():  # the render thread, just before the map lock
            materialize()
            waiting.set()

        f._materialize_host = materialize_then_lock
        lv._last_frame_id = -2  # render the current frame again
        assert waiting.wait(10)
        time.sleep(0.2)
    except BaseException:
        release.set()
        slam.shutdown()
        raise
    threading.Timer(hold_s, release.set).start()
    t0 = time.time()
    slam.shutdown()
    waited = time.time() - t0
    holder.join(timeout=10)
    assert not holder.is_alive() and waited > hold_s - 0.5
    assert _viewer_threads() == [] and not slam._worker.is_alive()
    assert lv.n_renders == 2 and lv.n_render_errors == 0


class _StubSystem:
    """What a LiveViewer reads of its system, with the menu's calls counted."""

    def __init__(self):
        self.config = types.SimpleNamespace(camera=types.SimpleNamespace(fps=20.0))
        self.map = types.SimpleNamespace(update_lock=threading.RLock(), n_keyframes=lambda: 4,
                                         n_map_points=lambda: 321)
        self.tracker = types.SimpleNamespace(current=None, localization_only=False,
                                             state=types.SimpleNamespace(name="OK"))
        self.calls = collections.Counter()

    def activate_localization_mode(self):
        self.calls["activate"] += 1
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.calls["deactivate"] += 1
        self.tracker.localization_only = False

    def reset(self):
        self.calls["reset"] += 1

    def get_tracking_state(self):
        return self.tracker.state.name


FORMS = [
    {"localization": ["on"], "points": ["on"]},
    {"points": ["on"], "graph": ["on"]},
    {"localization": ["on"]},
    {"localization": ["on"], "follow": ["on"], "keyframes": ["on"]},
    {"reset": ["1"]},
    {},
    {"localization": ["on"], "apply": ["1"]},
    {"localization": ["on"], "graph": ["on"]},
    {"reset": ["1"], "points": ["on"]},
]


def test_menu_logic_equals_the_jax_viewer(monkeypatch, tmp_path):
    """Both viewers, built and not started, each on a stub system, take the
    same menu forms: equal menus, equal calls to the system, equal state."""
    monkeypatch.chdir(tmp_path)  # the JAX viewer makes its snapshot directory here
    jstub, stub = _StubSystem(), _StubSystem()
    jlv, lv = JaxLiveViewer(jstub), LiveViewer(stub)
    try:
        assert lv.menu == jlv.menu and lv.period_s == jlv.period_s
        for form in FORMS:
            jlv.apply_menu(form)
            lv.apply_menu(form)
            assert lv.menu == jlv.menu, form
            assert stub.calls == jstub.calls, form
        assert lv.state() == jlv.state()
        assert stub.calls == {"activate": 3, "deactivate": 3, "reset": 2}
    finally:
        jlv._server.server_close()
        lv.shutdown()
    assert _viewer_threads() == [] and lv.n_renders == 0
