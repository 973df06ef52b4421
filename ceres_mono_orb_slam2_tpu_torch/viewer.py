"""Headless map and frame viewer (reference src/Viewer.cc, MapDrawer.cc,
FrameDrawer.cc).

Port of `ceres_mono_orb_slam2_tpu/viewer.py`. The reference opens a Pangolin
window with the point cloud, the keyframes and the covisibility graph,
spanning tree and loop edges, and an OpenCV window of the current frame
(FrameDrawer). Without a display the same content goes to PNG files: the
map seen from above (x-z) on a 1100x770 canvas, and the frame at the
image's own resolution with the reference's status bar under it.
`live_viewer.LiveViewer` serves the same renders over HTTP.

Extraction (reading map and tracker state) is split from rendering, so the
live viewer holds the map lock only for the copy, as the reference's
FrameDrawer does (FrameDrawer.cc:185-219 copies under its mutex, :35-181
draws the copy). Rendering is numpy on the host into a uint8 canvas, each
primitive drawn in one vectorised pass over all its items, and written by
`utils/png.py`: the card has no matplotlib, and a render thread shares the
interpreter lock with the tracker.
"""

from __future__ import annotations

import os

import numpy as np

from ceres_mono_orb_slam2_tpu_torch.utils import png

MAP_W, MAP_H = 1100, 770  # the JAX package's 10x7 in figure at 110 dpi
PLOT_BOX = (70, 40, MAP_W - 20, MAP_H - 40)  # the map's plot on the canvas: x0, y0, x1, y1 (exclusive)
BAR_H = 24  # the frame view's status bar under the image
FOLLOW_HALF_M = 8.0  # half width of the follow-camera window (metres)
TRACKED_HALF = 5  # half side of a tracked keypoint's square (FrameDrawer.cc:124-142)

WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
POINT = (120, 120, 120)  # map points
KEYFRAME = (0, 0, 255)
COVIS = (0, 191, 191)
TREE = (0, 128, 0)
LOOP = (191, 0, 0)
CAMERA = (255, 0, 0)
UNTRACKED = (128, 128, 128)
TRACKED = (0, 255, 0)

# 5x7 glyphs of printable ASCII (32-126): five column bytes each, bit r of a
# column the pixel in row r (row 0 at the top)
_FONT_HEX = (
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462" "3649552250"
    "0005030000" "001c224100" "0041221c00" "14083e0814" "08083e0808" "0050300000" "0808080808"
    "0060600000" "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31" "1814127f10"
    "2745454539" "3c4a494930" "0171090503" "3649494936" "064949291e" "0036360000" "0056360000"
    "0814224100" "1414141414" "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090901" "3e4149497a" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f020c027f" "7f0408107f" "3e4141413e" "7f09090906"
    "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f" "3f4038403f"
    "6314081463" "0708700807" "6151494543" "007f414100" "0204081020" "0041417f00" "0402010204"
    "4040404040" "0001020400" "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "0c5252523e" "7f08040478" "00447d4000" "2040443d00" "7f10284400" "00417f4000"
    "7c04180478" "7c08040478" "3844444438" "7c14141408" "081414187c" "7c08040408" "4854545420"
    "043f444020" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c" "4464544c44"
    "0008364100" "00007f0000" "0041360800" "0804081008"
)
_FONT = ((np.frombuffer(bytes.fromhex(_FONT_HEX), np.uint8).reshape(-1, 1, 5)
          >> np.arange(7, dtype=np.uint8)[None, :, None]) & 1).astype(bool)  # (95, 7, 5)
GLYPH_ADVANCE = 6  # pixels from one glyph to the next at scale 1


# ------------------------------------------------------------------ raster


def _pixels(xy) -> np.ndarray:
    """Nearest pixel of each (x, y), int64 (n, 2)."""
    return np.floor(np.asarray(xy, np.float64).reshape(-1, 2) + 0.5).astype(np.int64)


def _put(canvas: np.ndarray, x: np.ndarray, y: np.ndarray, color):
    """Set the pixels (x, y) that lie on the canvas to `color`."""
    h, w = canvas.shape[:2]
    keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    canvas[y[keep], x[keep]] = color


def _stamp(canvas: np.ndarray, xy, offsets: np.ndarray, color):
    """Draw the pixel pattern `offsets` (k, 2) centred at every point."""
    p = _pixels(xy)
    _put(canvas, (p[:, None, 0] + offsets[None, :, 0]).ravel(),
         (p[:, None, 1] + offsets[None, :, 1]).ravel(), color)


def _grid(half: int) -> np.ndarray:
    d = np.arange(-half, half + 1)
    return np.stack(np.meshgrid(d, d), -1).reshape(-1, 2)


def draw_squares(canvas: np.ndarray, xy, half: int, color, filled: bool = True):
    """A square of side 2 * half + 1 at every point; a point is half 0."""
    g = _grid(half)
    if not filled:
        g = g[np.abs(g).max(1) == half]
    _stamp(canvas, xy, g, color)


def draw_triangles(canvas: np.ndarray, xy, half: int, color):
    """A filled upward triangle (apex at the top) of height and base
    2 * half + 1 at every point."""
    g = _grid(half)
    _stamp(canvas, xy, g[2 * np.abs(g[:, 0]) <= g[:, 1] + half], color)


def draw_segments(canvas: np.ndarray, a, b, color):
    """Line segments a[i] -> b[i] (pixel coordinates, (n, 2)): each is
    clipped to the canvas (Liang-Barsky) and sampled once per pixel step."""
    a = np.asarray(a, np.float64).reshape(-1, 2)
    b = np.asarray(b, np.float64).reshape(-1, 2)
    h, w = canvas.shape[:2]
    d = b - a
    t0, t1 = np.zeros(len(a)), np.ones(len(a))
    keep = np.isfinite(a).all(1) & np.isfinite(b).all(1)
    for p, q in ((-d[:, 0], a[:, 0] + 0.5), (d[:, 0], w - 0.5 - a[:, 0]),
                 (-d[:, 1], a[:, 1] + 0.5), (d[:, 1], h - 0.5 - a[:, 1])):
        with np.errstate(divide="ignore", invalid="ignore"):
            r = q / p
        t0 = np.where(p < 0, np.maximum(t0, r), t0)
        t1 = np.where(p > 0, np.minimum(t1, r), t1)
        keep &= ~((p == 0) & (q < 0))
    keep &= t0 <= t1
    a, d, t0, t1 = a[keep], d[keep], t0[keep], t1[keep]
    if not len(a):
        return
    a, b = a + t0[:, None] * d, a + t1[:, None] * d
    d = b - a
    n = np.ceil(np.abs(d).max(1)).astype(np.int64) + 1  # samples a segment
    seg = np.repeat(np.arange(len(a)), n)
    k = np.arange(len(seg)) - np.repeat(np.cumsum(n) - n, n)
    t = k / np.maximum(n - 1, 1)[seg]
    p = _pixels(a[seg] + t[:, None] * d[seg])
    _put(canvas, p[:, 0], p[:, 1], color)


def text_width(text: str, scale: int = 1) -> int:
    return max(len(text) * GLYPH_ADVANCE - 1, 0) * scale


def draw_text(canvas: np.ndarray, x: int, y: int, text: str, color, scale: int = 1):
    """`text` in the 5x7 bitmap font, its top-left corner at (x, y); each
    font pixel a scale x scale block. Characters outside printable ASCII
    draw as '?'."""
    codes = np.frombuffer(text.encode("ascii", "replace"), np.uint8).astype(np.int64) - 32
    codes[(codes < 0) | (codes >= len(_FONT))] = ord("?") - 32
    ci, r, c = np.nonzero(_FONT[codes])
    d = np.arange(scale)
    block = np.stack(np.meshgrid(d, d), -1).reshape(-1, 2)
    px = (x + (ci * GLYPH_ADVANCE + c) * scale)[:, None] + block[None, :, 0]
    py = (y + r * scale)[:, None] + block[None, :, 1]
    _put(canvas, px.ravel(), py.ravel(), color)


# ----------------------------------------------------------------- renders


def status_text(g: dict) -> str:
    """The FrameDrawer's status bar (reference DrawTextInfo,
    FrameDrawer.cc:144-181), as the JAX package words it."""
    state = g["state"]
    mode = "LOCALIZATION | " if g["localization"] else ""
    if state == "OK":
        return ("%sSLAM MODE |  KFs: %d, MPs: %d, Matches: %d"
                % (mode, g["n_keyframes"], g["n_points"], int(g["tracked"].sum())))
    if state == "LOST":
        return "TRACK LOST. TRYING TO RELOCALIZE "
    if state == "NOT_INITIALIZED":
        return "TRYING TO INITIALIZE "
    return "WAITING FOR IMAGES"



def map_view(g: dict, show_points: bool = True, show_keyframes: bool = True,
             show_graph: bool = True, follow: bool = False):
    """The world x-z window of the map view: (x centre, z centre, pixels a
    metre). Equal scale, fitted to what is drawn with a 5% margin, or with
    `follow` a +/- FOLLOW_HALF_M window centred on the camera (the
    reference's s_cam.Follow(Twc), Viewer.cc:119-125)."""
    x0, y0, x1, y1 = PLOT_BOX
    pw, ph = x1 - x0, y1 - y0
    cam = g["camera"]
    if follow and cam is not None:
        return float(cam[0]), float(cam[2]), min(pw, ph) / (2 * FOLLOW_HALF_M)
    parts = [np.asarray(cam, np.float64).reshape(1, 3)] if cam is not None else []
    if show_points and g["points"] is not None:
        parts.append(np.asarray(g["points"], np.float64))
    if g["kf_centers"] is not None and (show_keyframes or show_graph):
        parts.append(np.asarray(g["kf_centers"], np.float64))
    xz = np.concatenate(parts)[:, [0, 2]] if parts else np.zeros((1, 2))
    xz = xz[np.isfinite(xz).all(1)]
    if not len(xz):
        xz = np.zeros((1, 2))
    lo, hi = xz.min(0), xz.max(0)
    span = np.maximum((hi - lo) * 1.1, 1e-3)
    c = (lo + hi) / 2
    return float(c[0]), float(c[1]), float(min(pw / span[0], ph / span[1]))


def render_map(g: dict, show_points: bool = True, show_keyframes: bool = True,
               show_graph: bool = True, follow: bool = False) -> np.ndarray:
    """The map seen from above as a (MAP_H, MAP_W, 3) uint8 canvas: map
    points gray, keyframe centres blue squares joined in id order,
    covisibility edges cyan, spanning tree green, loop edges red, the camera
    a red triangle, the title line above. The menu toggles are the Pangolin
    panel's (Viewer.cc:85-91)."""
    canvas = np.full((MAP_H, MAP_W, 3), 255, np.uint8)
    x0, y0, x1, y1 = PLOT_BOX
    plot = canvas[y0:y1, x0:x1]  # a view: drawing into it clips to the box
    cx, cz, s = map_view(g, show_points, show_keyframes, show_graph, follow)
    half_w, half_h = (x1 - x0) / 2, (y1 - y0) / 2

    def px(p):
        p = np.asarray(p, np.float64).reshape(-1, 3)
        return np.stack([half_w + (p[:, 0] - cx) * s, half_h - (p[:, 2] - cz) * s], -1)

    if show_points and g["points"] is not None:
        draw_squares(plot, px(g["points"]), 0, POINT)
    C = g["kf_centers"]
    if show_keyframes and C is not None:
        draw_segments(plot, px(C[:-1]), px(C[1:]), KEYFRAME)
    if show_graph:
        for edges, color in ((g["covis"], COVIS), (g["tree"], TREE), (g["loops"], LOOP)):
            if edges:
                e = np.asarray(edges, np.float64)  # (n, 2, 3)
                draw_segments(plot, px(e[:, 0]), px(e[:, 1]), color)
    if show_keyframes and C is not None:
        draw_squares(plot, px(C), 2, KEYFRAME)
    if g["camera"] is not None:
        draw_triangles(plot, px(g["camera"]), 6, CAMERA)
    # frame, axis labels and the corners' coordinates, title
    draw_segments(canvas, [(x0 - 1, y0 - 1), (x1, y0 - 1), (x1, y1), (x0 - 1, y1)],
                  [(x1, y0 - 1), (x1, y1), (x0 - 1, y1), (x0 - 1, y0 - 1)], BLACK)
    xl, xr = cx - half_w / s, cx + half_w / s
    zb, zt = cz - half_h / s, cz + half_h / s
    for x, y, t in ((x0, y1 + 6, "%.2f" % xl), (x1 - text_width("%.2f" % xr), y1 + 6, "%.2f" % xr),
                    ((x0 + x1 - text_width("x [m]")) // 2, y1 + 6, "x [m]"),
                    (x0 - 6 - text_width("%.2f" % zt), y0, "%.2f" % zt),
                    (x0 - 6 - text_width("%.2f" % zb), y1 - 7, "%.2f" % zb),
                    (x0 - 6 - text_width("z [m]"), (y0 + y1) // 2, "z [m]")):
        draw_text(canvas, x, y, t, BLACK)
    title = ("map: %d points, %d keyframes | state %s | inliers %d"
             % (g["n_points"], g["n_keyframes"], g["state"], g["inliers"]))
    scale = 2 if text_width(title, 2) <= MAP_W - 20 else 1
    draw_text(canvas, (MAP_W - text_width(title, scale)) // 2, 12, title, BLACK, scale)
    return canvas


def render_frame(g: dict) -> np.ndarray:
    """The FrameDrawer view (reference FrameDrawer.cc:35-181) as an
    (h + BAR_H, w, 3) uint8 canvas: the gray image, untracked keypoints as
    gray dots, each tracked keypoint a lime square with a centre dot, and
    the status bar (white on black) under the image."""
    img = g["image"]
    kp = np.asarray(g["kp_xy"], np.float64).reshape(-1, 2)
    if img is None:  # no image kept: a black field as large as the keypoints reach
        reach = np.ceil(kp[np.isfinite(kp).all(1)].max(0, initial=0.0)).astype(np.int64) + 1
        img = np.zeros((reach[1], reach[0]), np.uint8)
    h, w = img.shape
    canvas = np.zeros((h + BAR_H, w, 3), np.uint8)
    canvas[:h] = np.asarray(img, np.uint8)[..., None]
    view = canvas[:h]
    draw_squares(view, kp[g["untracked"]], 1, UNTRACKED)
    draw_squares(view, kp[g["tracked"]], TRACKED_HALF, TRACKED, filled=False)
    draw_squares(view, kp[g["tracked"]], 1, TRACKED)
    text = "frame %d | %s" % (g["frame"], status_text(g))
    scale = 2 if text_width(text, 2) <= w - 8 else 1
    draw_text(canvas, 4, h + (BAR_H - 7 * scale) // 2, text, WHITE, scale)
    return canvas


# ------------------------------------------------------------------ viewer


class Viewer:
    def __init__(self, config, map_, tracker, out_dir: str = "viewer_out", every: int = 10):
        self.config = config
        self.map = map_
        self.tracker = tracker
        self.out_dir = out_dir
        self.every = every
        self._count = 0

    def update(self):
        """Count a frame; every `every` frames write the map view to
        `out_dir/map_%05d.png` (the directory is made on the first write).
        The geometry is copied under map.update_lock, which a mapper thread
        takes per stage, and drawn outside it."""
        self._count += 1
        if self._count % self.every == 0:
            os.makedirs(self.out_dir, exist_ok=True)
            with self.map.update_lock:
                g = self.map_geometry()
            self.snapshot(os.path.join(self.out_dir, "map_%05d.png" % self._count), geom=g)

    # ------------------------------------------------------------ extraction

    def map_geometry(self) -> dict:
        """Copy everything the map render needs into plain numpy (cheap;
        safe to call under map.update_lock)."""
        m = self.map
        pts = [mp.pos for mp in m.all_map_points()]
        kfs = sorted(m.all_keyframes(), key=lambda k: k.id)
        centers = {kf.id: kf.camera_center() for kf in kfs}
        covis, tree, loops = [], [], []
        for kf in kfs:
            for nb, wgt in kf.covisible.items():
                if nb in centers and nb > kf.id and wgt >= 100:
                    covis.append((centers[kf.id], centers[nb]))
            if kf.parent is not None and kf.parent in centers:
                tree.append((centers[kf.id], centers[kf.parent]))
            for le in kf.loop_edges:
                if le in centers:
                    loops.append((centers[kf.id], centers[le]))
        f = self.tracker.current
        cam = f.camera_center() if (f is not None and f.pose_set) else None
        return {
            "points": np.stack(pts) if pts else None,
            "kf_centers": np.stack([centers[kf.id] for kf in kfs]) if kfs else None,
            "covis": covis, "tree": tree, "loops": loops, "camera": cam,
            "n_points": m.n_map_points(), "n_keyframes": m.n_keyframes(),
            "state": self.tracker.state.name,
            "inliers": self.tracker.matches_inliers,
        }

    def frame_geometry(self) -> dict:
        """Copy the current frame's draw state (reference
        FrameDrawer::Update, FrameDrawer.cc:185-219); safe to call under
        map.update_lock. A lazy frame's keypoints are fetched from the
        device here unless the caller fetched them first."""
        f = self.tracker.current
        if f is None:
            return {"frame": None}
        tracked = (f.mp_ids >= 0) & f.kp_valid
        img = self.tracker.current_image
        return {
            "frame": f.id,
            "image": None if img is None else np.asarray(img),
            "kp_xy": np.asarray(f.kp_xy),
            "tracked": np.asarray(tracked),
            "untracked": np.asarray(f.kp_valid & ~tracked),
            "state": self.tracker.state.name,
            "localization": self.tracker.localization_only,
            "n_keyframes": self.map.n_keyframes(),
            "n_points": self.map.n_map_points(),
        }

    # ------------------------------------------------------------- rendering

    def snapshot(self, path, geom: dict | None = None, show_points: bool = True,
                 show_keyframes: bool = True, show_graph: bool = True,
                 follow: bool = False):
        """Write the map view (`render_map`) as a PNG. `path` is a file name
        or a binary file-like object; returns it."""
        g = geom if geom is not None else self.map_geometry()
        png.write(path, render_map(g, show_points, show_keyframes, show_graph, follow))
        return path

    def draw_frame(self, path, geom: dict | None = None):
        """Write the FrameDrawer view (`render_frame`) as a PNG. `path` is a
        file name or a binary file-like object; returns it, or None when
        there is no current frame."""
        g = geom if geom is not None else self.frame_geometry()
        if g["frame"] is None:
            return None
        png.write(path, render_frame(g))
        return path
