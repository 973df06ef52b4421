"""Synthetic sequences with exact ground truth, rendered on the device.

Port of `ceres_mono_orb_slam2_tpu/utils/synthetic.py`: the same textured
plane worlds (`default_world`, `ring_world`) and camera trajectories, the
numpy ray tracer of `make_sequence` (the CLI's `--synthetic`), the
plane-intersection ray tracer of `render_frames_device` in torch, optionally
through a distorted lens, `ate_rmse` and `trajectory_positions`. Worlds and
noise are drawn from numpy generators seeded like the JAX package, so a seed
gives the same scene. Nothing is cached on disk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.ops import camera, lie


@dataclass
class Plane:
    origin: np.ndarray  # (3,) world point of texture (0, 0)
    ex: np.ndarray  # (3,) unit in-plane x axis, texture u direction
    ey: np.ndarray  # (3,) unit in-plane y axis
    size: tuple  # (su, sv) extent in meters
    texture: np.ndarray  # (Ht, Wt) float32


@dataclass
class SyntheticSequence:
    images: np.ndarray  # (T, H, W) float32
    poses_Rcw: np.ndarray  # (T, 3, 3) ground-truth world->camera
    poses_tcw: np.ndarray  # (T, 3)
    timestamps: np.ndarray  # (T,)
    K: np.ndarray  # (3, 3)

    @property
    def n_frames(self):
        return len(self.images)

    def gt_centers(self) -> np.ndarray:
        """Camera centres in the world frame, (T, 3)."""
        return np.einsum("tij,tj->ti", self.poses_Rcw.transpose(0, 2, 1), -self.poses_tcw)


def _make_texture(rng, size_uv, texel: float = 0.07):
    """Corner-rich, band-limited texture for a plane of physical size
    (su, sv) meters: smoothed noise, multi-scale intensity-ramped rectangles
    (so no two descriptor windows alias) and three octaves of value noise."""
    su, sv = size_uv
    wt = max(int(su / texel), 32)
    ht = max(int(sv / texel), 32)
    tex = rng.uniform(50, 110, (ht, wt)).astype(np.float32)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, (1, 1), (0, 1))) / 4
    n_blobs = (ht * wt) // 56
    sizes = np.exp(rng.uniform(np.log(3), np.log(26), (n_blobs, 2))).astype(np.int64)
    for (hh, ww) in sizes:
        y = rng.integers(0, max(ht - hh, 1))
        x = rng.integers(0, max(wt - ww, 1))
        base = rng.uniform(70, 220)
        gy, gx = rng.uniform(-8, 8, 2)
        tex[y: y + hh, x: x + ww] = base + gy * np.arange(hh)[:, None] + gx * np.arange(ww)[None, :]

    def octave(res_div, amp):
        small = rng.uniform(-1.0, 1.0, (max(ht // res_div, 2), max(wt // res_div, 2)))
        ys = np.linspace(0, small.shape[0] - 1, ht)
        xs = np.linspace(0, small.shape[1] - 1, wt)
        y0 = np.clip(ys.astype(np.int64), 0, small.shape[0] - 2)
        x0 = np.clip(xs.astype(np.int64), 0, small.shape[1] - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        v = ((1 - fy) * (1 - fx) * small[y0][:, x0] + (1 - fy) * fx * small[y0][:, x0 + 1]
             + fy * (1 - fx) * small[y0 + 1][:, x0] + fy * fx * small[y0 + 1][:, x0 + 1])
        return amp * v

    tex = tex + octave(32, 45.0) + octave(12, 32.0) + octave(5, 22.0)
    return np.clip(tex, 5, 250).astype(np.float32)


def _bilinear(tex, x, y):
    ht, wt = tex.shape
    x0 = np.clip(np.floor(x).astype(np.int64), 0, wt - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, ht - 2)
    fx = np.clip(x - x0, 0, 1)
    fy = np.clip(y - y0, 0, 1)
    return ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x0 + 1])
            + fy * ((1 - fx) * tex[y0 + 1, x0] + fx * tex[y0 + 1, x0 + 1]))


def _render(planes: List[Plane], K, Rcw, tcw, h, w, background=25.0):
    """Reference numpy ray tracer: float64 rays through every pixel, the
    nearest plane hit in front of the camera, bilinear texture sampling."""
    Rwc = Rcw.T
    c = -Rwc @ tcw  # camera centre in the world
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    d_cam = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones_like(us)], axis=-1)
    d_world = d_cam @ Rwc.T  # (h, w, 3)
    img = np.full((h, w), background, np.float32)
    best_s = np.full((h, w), np.inf)
    for pl in planes:
        n = np.cross(pl.ex, pl.ey)
        denom = d_world @ n
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        s = ((pl.origin - c) @ n) / denom  # ray parameter
        X = c + s[..., None] * d_world
        rel = X - pl.origin
        tu = rel @ pl.ex
        tv = rel @ pl.ey
        ht, wt = pl.texture.shape
        su, sv = pl.size
        inside = (s > 0.1) & (tu >= 0) & (tu < su) & (tv >= 0) & (tv < sv) & (s < best_s)
        vals = _bilinear(pl.texture, tu / su * (wt - 1), tv / sv * (ht - 1))
        img = np.where(inside, vals.astype(np.float32), img)
        best_s = np.where(inside, s, best_s)
    return img


def default_world(rng, extent: float = 20.0) -> List[Plane]:
    """Two near-fronto-parallel walls at different depths, mid-depth strips
    and floating camera-facing quads (no grazing-incidence surfaces)."""
    planes = [Plane(
        origin=np.array([-6.0, -4.0, 10.0]),
        ex=np.array([1.0, 0.0, 0.04]) / np.linalg.norm([1.0, 0.0, 0.04]),
        ey=np.array([0.0, 1.0, 0.0]),
        size=(extent + 14, 8.0),
        texture=_make_texture(rng, (extent + 14, 8.0), texel=0.07),
    )]
    seg = 3.0
    x0 = -4.0
    while x0 < extent + 4.0:
        if rng.random() < 0.5:
            zc = rng.uniform(6.0, 7.5)
            yc = rng.uniform(-3.0, 0.5)
            planes.append(Plane(
                origin=np.array([x0, yc, zc]),
                ex=np.array([1.0, 0.0, rng.uniform(-0.08, 0.08)]),
                ey=np.array([0.0, 1.0, 0.0]),
                size=(seg * rng.uniform(0.6, 1.0), rng.uniform(1.5, 3.0)),
                texture=_make_texture(rng, (seg, 2.5), texel=0.05),
            ))
        x0 += seg
    for _ in range(max(int((extent + 10) * 1.2), 12)):
        cx_ = rng.uniform(-3.0, extent + 3.0)
        cy_ = rng.uniform(-2.2, 2.2)
        cz_ = rng.uniform(3.5, 8.0)
        tilt = rng.uniform(-0.4, 0.4, 2)
        ex = np.array([1.0, 0.0, tilt[0]])
        ex /= np.linalg.norm(ex)
        ey = np.array([0.0, 1.0, tilt[1]])
        ey -= ex * (ey @ ex)
        ey /= np.linalg.norm(ey)
        size = (rng.uniform(0.6, 1.4), rng.uniform(0.6, 1.4))
        planes.append(Plane(
            origin=np.array([cx_, cy_, cz_]) - ex * size[0] / 2 - ey * size[1] / 2,
            ex=ex, ey=ey, size=size, texture=_make_texture(rng, size, texel=0.035),
        ))
    return planes


def ring_world(rng, radius: float = 8.0) -> List[Plane]:
    """Inward-facing textured wall segments in a ring plus floating quads:
    a camera circling inside revisits the same walls every revolution."""
    planes = []
    n_seg = 26
    for i in range(n_seg):
        a0 = 2 * np.pi * i / n_seg
        a1 = 2 * np.pi * (i + 1) / n_seg
        p0 = np.array([radius * np.sin(a0), -3.0, radius * np.cos(a0)])
        p1 = np.array([radius * np.sin(a1), -3.0, radius * np.cos(a1)])
        ex = p1 - p0
        seg_len = np.linalg.norm(ex)
        planes.append(Plane(
            origin=p0, ex=ex / seg_len, ey=np.array([0.0, 1.0, 0.0]), size=(seg_len, 6.0),
            texture=_make_texture(rng, (seg_len, 6.0), texel=0.06),
        ))
    for _ in range(28):
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(5.0, 7.0)
        c = np.array([rad * np.sin(ang), rng.uniform(-1.5, 1.5), rad * np.cos(ang)])
        ex = np.array([np.cos(ang), 0.0, -np.sin(ang)]) + rng.uniform(-0.3, 0.3) * np.array([0, 0, 1])
        ex /= np.linalg.norm(ex)
        ey = np.array([0.0, 1.0, 0.0])
        ey = ey - ex * (ey @ ex)
        ey /= np.linalg.norm(ey)
        size = (rng.uniform(0.7, 1.4), rng.uniform(0.7, 1.4))
        planes.append(Plane(
            origin=c - ex * size[0] / 2 - ey * size[1] / 2, ex=ex, ey=ey,
            size=size, texture=_make_texture(rng, size, texel=0.035),
        ))
    return planes


def camera_pose(k: int, motion: str, step: float):
    """Ground-truth (Rcw, tcw) of frame k for the trajectories of
    `make_sequence`: strafe, forward, circle, spiral (circle + a slow
    absolute-rate rise, so prefixes of longer runs coincide) or orbit."""
    if motion == "strafe":
        c = np.array([k * step, 0.1 * np.sin(k * 0.3), 0.04 * np.sin(k * 0.2)])
        w_rot = np.array([0.003 * np.sin(k * 0.5), 0.004 * k, 0.001 * k])
    elif motion == "forward":
        c = np.array([0.3 * k * step, 0.0, 0.6 * k * step])
        w_rot = np.array([0.0, 0.002 * k, 0.0])
    elif motion == "circle":
        a = step * k
        c = np.array([3.0 * np.sin(a), 0.02 * np.sin(3 * a), 3.0 * np.cos(a)])
        w_rot = np.array([0.0, a, 0.0])
    elif motion == "spiral":
        a = step * k
        y = -1.3 + 0.0013 * k
        c = np.array([3.0 * np.sin(a), y + 0.02 * np.sin(3 * a), 3.0 * np.cos(a)])
        w_rot = np.array([0.0, a, 0.0])
    else:  # orbit
        ang = 0.015 * k
        c = np.array([4.0 * np.sin(ang), 0.0, 4.0 * (1 - np.cos(ang))])
        w_rot = np.array([0.0, ang, 0.0])
    Rwc = lie.so3_exp(torch.as_tensor(w_rot, dtype=torch.float32)).double().numpy()
    Rcw = Rwc.T
    return Rcw, -Rcw @ c


def _world(rng, motion: str, n_frames: int, step: float) -> List[Plane]:
    """The ring world for circle / spiral motion, else the default world."""
    if motion in ("circle", "spiral"):
        return ring_world(rng)
    return default_world(rng, extent=max(n_frames * step * 1.5, 10.0))


def make_sequence(n_frames: int = 40, h: int = 480, w: int = 640, fx: float = 500.0,
                  fy: float = 500.0, motion: str = "strafe", step: float = 0.06, seed: int = 0,
                  noise: float = 1.0, fps: float = 30.0) -> SyntheticSequence:
    """Ray-traced sequence from the numpy renderer (the JAX package's
    `make_sequence` without its disk cache): principal point at the image
    centre, Gaussian pixel noise drawn frame by frame from the world's
    generator."""
    rng = np.random.default_rng(seed)
    K = np.array([[fx, 0, w / 2.0], [0, fy, h / 2.0], [0, 0, 1]], np.float32)
    planes = _world(rng, motion, n_frames, step)
    Rs, ts, images = [], [], []
    for k in range(n_frames):
        Rcw, tcw = camera_pose(k, motion, step)
        img = _render(planes, K.astype(np.float64), Rcw, tcw, h, w)
        if noise > 0:
            img = img + rng.standard_normal(img.shape).astype(np.float32) * noise
        images.append(np.clip(img, 0, 255).astype(np.float32))
        Rs.append(Rcw.astype(np.float32))
        ts.append(tcw.astype(np.float32))
    return SyntheticSequence(images=np.stack(images), poses_Rcw=np.stack(Rs), poses_tcw=np.stack(ts),
                             timestamps=np.arange(n_frames, dtype=np.float64) / fps, K=K)


def _resample_texture(tex: np.ndarray, th: int, tw: int) -> np.ndarray:
    ys = np.linspace(0, tex.shape[0] - 1, th)
    xs = np.linspace(0, tex.shape[1] - 1, tw)
    return _bilinear(tex, xs[None, :].repeat(th, 0), ys[:, None].repeat(tw, 1)).astype(np.float32)


@torch.no_grad()
def render_frames_device(planes: List[Plane], K, Rcw, tcw, h: int, w: int,
                         background: float = 25.0, chunk: int = 8, tex_h: int = 160,
                         tex_w: int = 512, dist=None, device="cpu") -> np.ndarray:
    """Per-pixel plane-intersection ray tracer over all planes, batched over
    `chunk` frames, on `device`. Textures are resampled to a common
    (tex_h, tex_w) and sampled bilinearly in normalised coordinates. With
    `dist` (OpenCV k1 k2 p1 p2 k3) the image is a distorted lens's: the ray
    of output pixel (u, v) is the one whose distorted projection lands there,
    found by `camera.undistort_points` on the pixel grid (the model the
    frames undistort their keypoints with).
    Rcw (T, 3, 3), tcw (T, 3) -> (T, h, w) float32 numpy."""
    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    origin = f32(np.stack([p.origin for p in planes]))  # (P, 3)
    ex = f32(np.stack([p.ex for p in planes]))
    ey = f32(np.stack([p.ey for p in planes]))
    size = f32(np.array([p.size for p in planes]))  # (P, 2)
    tex = f32(np.stack([_resample_texture(p.texture, tex_h, tex_w) for p in planes]))
    Kt = f32(K)
    n = torch.cross(ex, ey, dim=-1)  # (P, 3)
    vs, us = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    if dist is not None:
        d5 = np.zeros(5, np.float32)  # k3 = 0 for a 4-coefficient lens
        d5[: len(dist)] = dist
        und = camera.undistort_points(torch.stack([us.reshape(-1), vs.reshape(-1)], -1), Kt,
                                      f32(d5)).reshape(h, w, 2)
        us, vs = und[..., 0], und[..., 1]
    d_cam = torch.stack([(us - Kt[0, 2]) / Kt[0, 0], (vs - Kt[1, 2]) / Kt[1, 1],
                         torch.ones_like(us)], -1)  # (h, w, 3)
    P = len(planes)
    pidx = torch.arange(P, device=dev)[:, None, None]
    out = []
    for i in range(0, len(Rcw), chunk):
        R = f32(Rcw[i:i + chunk])
        t = f32(tcw[i:i + chunk])
        Rwc = R.transpose(1, 2)
        c = -(Rwc @ t[..., None])[..., 0]  # (F, 3) camera centres
        for fi in range(R.shape[0]):
            d_world = d_cam @ Rwc[fi].T  # (h, w, 3)
            denom = torch.einsum("hwk,pk->phw", d_world, n)
            denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
            s = ((origin - c[fi]) * n).sum(-1)[:, None, None] / denom  # (P, h, w)
            X = c[fi] + s[..., None] * d_world[None]
            rel = X - origin[:, None, None, :]
            tu = (rel * ex[:, None, None, :]).sum(-1)
            tv = (rel * ey[:, None, None, :]).sum(-1)
            su = size[:, 0, None, None]
            sv = size[:, 1, None, None]
            inside = (s > 0.1) & (tu >= 0) & (tu < su) & (tv >= 0) & (tv < sv)
            tx = (tu / su * (tex_w - 1)).clamp(0.0, tex_w - 1.0)
            ty = (tv / sv * (tex_h - 1)).clamp(0.0, tex_h - 1.0)
            x0 = torch.floor(tx).to(torch.int64).clamp(0, tex_w - 2)
            y0 = torch.floor(ty).to(torch.int64).clamp(0, tex_h - 2)
            fx = tx - x0
            fy = ty - y0
            val = ((1 - fy) * ((1 - fx) * tex[pidx, y0, x0] + fx * tex[pidx, y0, x0 + 1])
                   + fy * ((1 - fx) * tex[pidx, y0 + 1, x0] + fx * tex[pidx, y0 + 1, x0 + 1]))
            s_all = torch.where(inside, s, torch.full_like(s, float("inf")))
            best = s_all.argmin(0)
            hit = torch.isfinite(s_all.amin(0))
            img = torch.gather(val, 0, best[None])[0]
            out.append(torch.where(hit, img, torch.full_like(img, background)).cpu().numpy())
    return np.stack(out)


def make_rendered_sequence(n_frames: int, h: int, w: int, fx: float, fy: float,
                           motion: str = "strafe", step: float = 0.06, seed: int = 0,
                           noise: float = 1.0, fps: float = 30.0, dist=None, cx=None, cy=None,
                           device="cpu") -> SyntheticSequence:
    """The worlds and trajectories of `make_sequence`, rendered on `device`
    (the JAX package's `make_rendered_sequence_device` without its disk
    cache): ring world for circle/spiral motion, else the default world;
    Gaussian pixel noise from the same seeded generator. `dist`: OpenCV
    distortion coefficients of the lens the frames are rendered through;
    `cx`, `cy`: the principal point (default the image centre)."""
    rng = np.random.default_rng(seed)
    cx = w / 2.0 if cx is None else cx
    cy = h / 2.0 if cy is None else cy
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    planes = _world(rng, motion, n_frames, step)
    poses = [camera_pose(k, motion, step) for k in range(n_frames)]
    Rcw = np.stack([p[0] for p in poses]).astype(np.float32)
    tcw = np.stack([p[1] for p in poses]).astype(np.float32)
    images = render_frames_device(planes, K, Rcw, tcw, h, w, dist=dist, device=device)
    if noise > 0:
        images = images + rng.standard_normal(images.shape).astype(np.float32) * noise
    return SyntheticSequence(images=np.clip(images, 0, 255).astype(np.float32),
                             poses_Rcw=Rcw, poses_tcw=tcw,
                             timestamps=np.arange(n_frames, dtype=np.float64) / fps, K=K)


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error of camera centres after Sim(3) alignment
    (monocular scale is free, so the alignment includes it)."""
    est = est_t.astype(np.float64)
    gt = gt_t.astype(np.float64)
    if align:
        ce, cg = est.mean(0), gt.mean(0)
        e0, g0 = est - ce, gt - cg
        s = np.sqrt((g0 ** 2).sum() / max((e0 ** 2).sum(), 1e-12))
        U, _, Vt = np.linalg.svd(g0.T @ e0)
        D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
        est = (s * ((U @ D @ Vt) @ e0.T)).T + cg
        gt = g0 + cg
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def trajectory_positions(trajectory, map_, timestamps, poses_Rcw, poses_tcw, exclude=frozenset()):
    """A `Tracking.trajectory` log (keyframe-relative poses) resolved into
    estimated and ground-truth camera centres, following culled keyframes'
    parent chains (`Map.resolve_kf_pose`). Returns (est (K, 3), gt (K, 3),
    tracked frames): every non-lost entry's sequence index is in the last,
    resolvable or not; `exclude` frames are left out of est and gt only."""
    ts_arr = np.asarray(timestamps)
    est, gt, tracked = [], [], []
    for kf_id, R_rel, t_rel, ts, lost in trajectory:
        if lost:
            continue
        k = int(np.argmin(np.abs(ts_arr - ts)))
        tracked.append(k)
        if k in exclude:
            continue
        pose = map_.resolve_kf_pose(kf_id, R_rel, t_rel)
        if pose is None:
            continue
        Rcw, tcw = pose
        est.append(-Rcw.T @ tcw)
        gt.append(-poses_Rcw[k].T @ poses_tcw[k])
    return np.asarray(est), np.asarray(gt), tracked
