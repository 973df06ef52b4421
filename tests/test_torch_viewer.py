"""The port's headless viewer (`viewer.py`) on the CPU: the port's
`MonoSLAM(use_viewer=True)` over the 6 strafe frames of
`tests/test_viewer.py`. The tracker keeps the frame's image; the map and
frame geometry equal the JAX package's `Viewer` built on the port's objects,
exactly; the renders, decoded by `utils/png.py`, hold the drawing rules; the
status bar words are the JAX package's; `update()` writes its snapshots.
About 15 s alone on two threads."""

import io
import os

import matplotlib.axes
import numpy as np
import pytest
import torch
from scipy.ndimage import maximum_filter

from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu.viewer import Viewer as JaxViewer
from ceres_mono_orb_slam2_tpu_torch import viewer as V
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.utils import png
from ceres_mono_orb_slam2_tpu_torch.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes

torch.set_num_threads(2)
H, W = 480, 640
WHITE = V.WHITE


def _config():
    return SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=1500),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096))


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=6, motion="strafe", step=0.12, seed=11)


@pytest.fixture(scope="module")
def run(seq, tmp_path_factory):
    """The system after the 6 frames; its viewer writes every 3rd frame."""
    snaps = tmp_path_factory.mktemp("snaps")
    slam = MonoSLAM(_config(), device="cpu", use_viewer=True)
    slam.viewer.out_dir, slam.viewer.every = str(snaps), 3
    for k in range(6):
        slam.track_monocular(seq.images[k], seq.timestamps[k])
    yield slam, snaps
    slam.shutdown()


def _u8(img):
    return np.clip(img + 0.5, 0.0, 255.0).astype(np.uint8)


def test_current_image_is_the_tracked_frame(run, seq):
    slam, _ = run
    assert slam.get_tracking_state() == "OK" and slam.map.n_keyframes() >= 2
    assert np.array_equal(slam.tracker.current_image, _u8(seq.images[5]))


def test_pipelined_current_image_is_the_consumed_frame(seq):
    """With a frame in flight, `current` is the frame before it, and so is
    `current_image`."""
    u8 = _u8(seq.images)
    slam = MonoSLAM(_config(), device="cpu", pipelined=True)
    in_flight = 0
    try:
        for k in range(6):
            slam.track_monocular(seq.images[k], seq.timestamps[k])
            t = slam.tracker
            i = int(np.argmin(np.abs(seq.timestamps - t.current.timestamp)))
            assert np.array_equal(t.current_image, u8[i]), k
            in_flight += t._pending is not None and i < k
        assert in_flight >= 1 and slam.tracker.n_chained_frames >= 1
    finally:
        slam.shutdown()
    assert np.array_equal(slam.tracker.current_image, u8[5])


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_geometry_equals_the_jax_viewer(run, tmp_path):
    """The JAX package's Viewer reads the port's map and tracker (duck-typed
    numpy) and must extract exactly what the port's does; a loop edge is
    added for the run of the check, so every edge kind is present."""
    slam, _ = run
    jv = JaxViewer(slam.config, slam.map, slam.tracker, out_dir=str(tmp_path))
    kfs = sorted(slam.map.all_keyframes(), key=lambda k: k.id)
    a, b = kfs[0], kfs[-1]
    a.loop_edges.add(b.id)
    b.loop_edges.add(a.id)
    try:
        mg = slam.viewer.map_geometry()
        assert _equal(mg, jv.map_geometry())
    finally:
        a.loop_edges.discard(b.id)
        b.loop_edges.discard(a.id)
    assert mg["covis"] and mg["tree"] and len(mg["loops"]) == 2 and mg["camera"] is not None
    fg = slam.viewer.frame_geometry()
    assert _equal(fg, jv.frame_geometry())
    assert fg["tracked"].sum() > 100 and fg["untracked"].sum() > 0


def test_frame_render(run, tmp_path):
    slam, _ = run
    g = slam.viewer.frame_geometry()
    path = slam.viewer.draw_frame(str(tmp_path / "frame.png"))
    with open(path, "rb") as f:
        img = png.decode(f.read())
    assert img.shape == (H + V.BAR_H, W, 3)
    view = img[:H]
    # every tracked keypoint's square is lime where it lies on the image
    p = np.floor(g["kp_xy"][g["tracked"]] + 0.5).astype(np.int64)
    d = np.arange(-V.TRACKED_HALF, V.TRACKED_HALF + 1)
    ox, oy = np.meshgrid(d, d)
    ring = np.abs(np.stack([ox.ravel(), oy.ravel()], 1)).max(1) == V.TRACKED_HALF
    xs = (p[:, None, 0] + ox.ravel()[ring]).ravel()
    ys = (p[:, None, 1] + oy.ravel()[ring]).ravel()
    on = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    assert on.sum() > 1000
    assert (view[ys[on], xs[on]] == V.TRACKED).all()
    # away from every keypoint the image's own gray, in all three channels
    near = np.zeros((H, W), bool)
    q = np.floor(g["kp_xy"][g["tracked"] | g["untracked"]] + 0.5).astype(np.int64)
    q = q[(q[:, 0] >= 0) & (q[:, 0] < W) & (q[:, 1] >= 0) & (q[:, 1] < H)]
    near[q[:, 1], q[:, 0]] = True
    far = ~maximum_filter(near, size=2 * V.TRACKED_HALF + 3)
    assert far.sum() > 0.2 * H * W
    for c in range(3):
        assert np.array_equal(view[..., c][far], g["image"][far])
    # the status bar: black with white text
    bar = img[H:]
    colours = {tuple(c) for c in np.unique(bar.reshape(-1, 3), axis=0)}
    assert colours == {(0, 0, 0), (255, 255, 255)}


def test_status_text_is_the_jax_title(run, monkeypatch, tmp_path):
    """The JAX FrameDrawer titles its figure "frame N | <status>"; the port
    draws the same words in its bar. Each state, with and without
    localization mode."""
    slam, _ = run
    titles = []
    monkeypatch.setattr(matplotlib.axes.Axes, "set_title", lambda self, t, *a, **k: titles.append(t))
    jv = JaxViewer(slam.config, slam.map, slam.tracker, out_dir=str(tmp_path))
    rng = np.random.default_rng(0)
    tracked = rng.uniform(size=40) < 0.5
    for state in ("OK", "LOST", "NOT_INITIALIZED", "NO_IMAGES_YET"):
        for loc in (False, True):
            g = {"frame": 7, "image": np.zeros((8, 8), np.uint8), "kp_xy": rng.uniform(0, 8, (40, 2)),
                 "tracked": tracked, "untracked": ~tracked, "state": state, "localization": loc,
                 "n_keyframes": 3, "n_points": 412}
            jv.draw_frame(io.BytesIO(), geom=g)
            assert titles[-1] == "frame 7 | " + V.status_text(g), (state, loc)
    assert V.status_text(g) == "WAITING FOR IMAGES"
    assert len(titles) == 8


def _colour_count(img, colour):
    return int((img == np.array(colour, np.uint8)).all(-1).sum())


def test_map_render(run, tmp_path):
    slam, _ = run
    g = slam.viewer.map_geometry()
    buf = io.BytesIO()
    assert slam.viewer.snapshot(buf, geom=g) is buf
    img = png.decode(buf.getvalue())
    assert img.shape == (V.MAP_H, V.MAP_W, 3)
    for colour in (V.POINT, V.KEYFRAME, V.TREE, V.CAMERA, V.BLACK):
        assert _colour_count(img, colour) > 0, colour
    # the covisibility edges lie under the tree's here: alone they show
    covis_only = V.render_map(dict(g, tree=[], loops=[]), show_keyframes=False)
    assert _colour_count(covis_only, V.COVIS) > 0 and _colour_count(covis_only, V.TREE) == 0
    no_points = png.decode(slam.viewer.snapshot(io.BytesIO(), geom=g, show_points=False).getvalue())
    assert _colour_count(no_points, V.POINT) == 0
    bare = V.render_map(g, show_points=False, show_keyframes=False, show_graph=False)
    for colour in (V.POINT, V.KEYFRAME, V.COVIS, V.TREE):
        assert _colour_count(bare, colour) == 0, colour
    assert _colour_count(bare, V.CAMERA) > 0
    # follow: the camera's triangle is centred in the plot box
    followed = V.render_map(g, follow=True)
    ys, xs = np.nonzero((followed == np.array(V.CAMERA, np.uint8)).all(-1))
    x0, y0, x1, y1 = V.PLOT_BOX
    assert abs((xs.min() + xs.max()) / 2 - (x0 + x1 - 1) / 2) <= 1.0
    assert abs((ys.min() + ys.max()) / 2 - (y0 + y1 - 1) / 2) <= 1.0
    assert V.map_view(g, follow=True)[2] == min(x1 - x0, y1 - y0) / (2 * V.FOLLOW_HALF_M)
    # without follow the view fits the camera too, elsewhere than the centre
    fitted = V.render_map(g)
    ys2, xs2 = np.nonzero((fitted == np.array(V.CAMERA, np.uint8)).all(-1))
    assert len(xs2) and (xs2.min(), ys2.min()) != (xs.min(), ys.min())


def test_update_writes_snapshots(run, tmp_path):
    """The system's viewer (every 3rd of 6 frames) wrote two; a second
    viewer with every=2 writes on the 2nd and the 4th update."""
    slam, snaps = run
    assert sorted(os.listdir(snaps)) == ["map_00003.png", "map_00006.png"]
    for name in os.listdir(snaps):
        with open(snaps / name, "rb") as f:
            assert png.decode(f.read()).shape == (V.MAP_H, V.MAP_W, 3)
    v = V.Viewer(slam.config, slam.map, slam.tracker, out_dir=str(tmp_path / "out"), every=2)
    for _ in range(5):
        v.update()
    assert sorted(os.listdir(tmp_path / "out")) == ["map_00002.png", "map_00004.png"]


def test_no_frame_draws_nothing(tmp_path):
    """Before the first frame there is nothing to draw: draw_frame returns
    None and writes no file, and the map view still renders."""
    slam = MonoSLAM(_config(), device="cpu", use_viewer=True)
    try:
        assert slam.viewer.draw_frame(str(tmp_path / "f.png")) is None
        assert not (tmp_path / "f.png").exists()
        g = slam.viewer.map_geometry()
        assert g["points"] is None and g["camera"] is None and g["state"] == "NO_IMAGES_YET"
        assert V.render_map(g).shape == (V.MAP_H, V.MAP_W, 3)
    finally:
        slam.shutdown()


def test_raster_primitives():
    """Segments are clipped to the canvas and leave no gap; text is drawn
    from the bitmap font."""
    c = np.zeros((20, 30, 3), np.uint8)
    V.draw_segments(c, [(-100.0, 5.0), (3.0, -50.0), (40.0, 40.0)], [(100.0, 5.0), (3.0, 50.0), (50.0, 60.0)],
                    WHITE)
    lit = (c == 255).all(-1)
    assert lit[5].all() and lit[:, 3].all() and lit.sum() == 30 + 20 - 1
    c = np.zeros((20, 30, 3), np.uint8)
    V.draw_segments(c, [(2.0, 2.0)], [(9.0, 17.0)], WHITE)
    ys, xs = np.nonzero((c == 255).all(-1))
    assert sorted(set(ys.tolist())) == list(range(2, 18))
    c = np.zeros((9, 20, 3), np.uint8)
    V.draw_text(c, 1, 1, "I!", WHITE)
    assert (c[1:8, 3] == 255).all() and (c[1:6, 9] == 255).all() and (c[6, 9] == 0).all()
    assert (c[7, 9] == 255).all() and V.text_width("I!") == 11
