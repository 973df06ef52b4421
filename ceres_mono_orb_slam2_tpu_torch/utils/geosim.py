"""Geometric (frontend-bypass) simulation: synthetic landmarks observed
through ground-truth poses, each landmark carrying a fixed random 256-bit
descriptor.

Drives the FULL SLAM system (matching, tracking, mapping, loop closing)
without the image pipeline: extraction becomes projection, so sequences of
hundreds of frames run in seconds and ground-truth identity is available for
every observation. Port of `ceres_mono_orb_slam2_tpu/utils/geosim.py`; the
loop-closure end-to-end test and chip_smoke.py's loop phase drive the system
with it (the reference validated loop closing only on full dataset runs; this
gives the equivalent coverage with exact ground truth)."""

from __future__ import annotations

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.ops import lie
from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import FrameFeatures
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class GeoWorld:
    """Random landmark cloud; `shape='box'` for lateral trajectories,
    `shape='ring'` (annulus around the origin) for closed orbits."""

    def __init__(self, rng, n_landmarks: int, extent: float = 10.0,
                 shape: str = "box", r_inner: float = 6.0, r_outer: float = 11.0):
        n = n_landmarks
        if shape == "ring":
            ang = rng.uniform(0, 2 * np.pi, n)
            rad = rng.uniform(r_inner, r_outer, n)
            self.pos = np.stack(
                [rad * np.sin(ang), rng.uniform(-3.0, 3.0, n), rad * np.cos(ang)], axis=-1
            ).astype(np.float64)
        else:
            self.pos = np.stack(
                [
                    rng.uniform(-6.0, extent + 6.0, n),
                    rng.uniform(-4.0, 4.0, n),
                    rng.uniform(3.5, 11.0, n),
                ],
                axis=-1,
            ).astype(np.float64)
        self.desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        # intrinsic detection level per landmark, distributed like a real
        # extractor's per-level budget (most features at level 0)
        self.base_level = rng.choice(
            np.arange(5), size=n, p=[0.45, 0.22, 0.15, 0.11, 0.07]).astype(np.int32)


def make_geo_trajectory(n_frames: int, motion: str = "strafe", step: float = 0.12,
                        radius: float = 3.0):
    """GT (Rcw, tcw). `circle`: camera on a radius-`radius` circle about the
    origin looking radially outward, angular increment `step` rad/frame —
    revisits the start after 2*pi/step frames (loop-closure scenario)."""
    Rs, ts = [], []
    for k in range(n_frames):
        if motion == "circle":
            a = step * k
            c = np.array([radius * np.sin(a), 0.02 * np.sin(3 * a), radius * np.cos(a)])
            w_rot = np.array([0.0, a, 0.0])
        elif motion == "strafe":
            c = np.array([k * step, 0.1 * np.sin(k * 0.3), 0.04 * np.sin(k * 0.2)])
            w_rot = np.array([0.003 * np.sin(k * 0.5), 0.004 * k, 0.001 * k])
        elif motion == "forward":
            c = np.array([0.3 * k * step, 0.0, 0.6 * k * step])
            w_rot = np.array([0.0, 0.002 * k, 0.0])
        else:  # orbit (legacy open arc)
            a = 0.015 * k
            c = np.array([4.0 * np.sin(a), 0.0, 4.0 * (1 - np.cos(a))])
            w_rot = np.array([0.0, a, 0.0])
        Rwc = lie.so3_exp(torch.as_tensor(w_rot.astype(np.float32))).double().numpy()
        Rcw = Rwc.T
        Rs.append(Rcw.astype(np.float32))
        ts.append((-Rcw @ c).astype(np.float32))
    return np.stack(Rs), np.stack(ts)


class GeoExtractor:
    """Drop-in for ORBExtractor: the 'image' is a (H, W) array whose [0, 0]
    pixel encodes the frame index; returns projections of the landmark cloud
    under the GT pose for that frame, with pixel and descriptor-bit noise."""

    def __init__(self, world: GeoWorld, K, Rcw, tcw, n_features, h, w,
                 px_noise=0.3, bit_noise=2, seed=0, blackout=(), device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.blackout = set(blackout)  # frames returning zero features
        self.world = world
        self.K = K
        self.Rcw = Rcw
        self.tcw = tcw
        self.n = n_features
        self.h, self.w = h, w
        self.px_noise = px_noise
        self.bit_noise = bit_noise
        self.rng = np.random.default_rng(seed + 1000)
        self.slot_lm_by_frame = {}
        self.last_frame_idx = -1
        # octave-shift anchor = median visible depth at frame 0 (so roughly
        # half the frame-0 keypoints sit at their landmark's base level and
        # level 0 is well-populated for initialization in ANY world geometry)
        X0 = world.pos @ Rcw[0].astype(np.float64).T + tcw[0].astype(np.float64)
        vis0 = X0[:, 2] > 0.3
        self.depth_anchor = float(np.median(X0[vis0, 2])) if vis0.any() else 8.0

    def extract(self, image):
        if image.ndim == 3:
            image = image[0]
        k = int(round(float(image[0, 0])))
        self.last_frame_idx = k
        if k in self.blackout:  # total occlusion: no features this frame
            N = self.n
            self.slot_lm_by_frame[k] = np.full(N, -1, np.int64)
            return self._features(np.zeros((N, 2), np.float32), np.zeros(N, np.float32),
                                  np.zeros(N, np.int32), np.zeros((N, 32), np.uint8),
                                  np.zeros(N, bool))
        R, t = self.Rcw[k].astype(np.float64), self.tcw[k].astype(np.float64)
        Xc = self.world.pos @ R.T + t
        z = Xc[:, 2]
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        u = fx * Xc[:, 0] / np.maximum(z, 1e-9) + cx
        v = fy * Xc[:, 1] / np.maximum(z, 1e-9) + cy
        vis = (z > 0.3) & (u >= 20) & (u < self.w - 20) & (v >= 20) & (v < self.h - 20)
        ids = np.nonzero(vis)[0]
        if len(ids) > self.n:
            ids = self.rng.permutation(ids)[: self.n]
        m = len(ids)
        N = self.n
        xy = np.zeros((N, 2), np.float32)
        desc = np.zeros((N, 32), np.uint8)
        valid = np.zeros(N, bool)
        octv = np.zeros(N, np.int32)
        # pyramid level = landmark's intrinsic level shifted by distance,
        # like a real image pyramid (a single-octave world makes
        # KeyFrameCulling's same-or-finer-scale test trivially true and
        # starves the map of keyframes at the frontier)
        shift = np.round(np.log(self.depth_anchor / z[ids]) / np.log(1.2))
        octv[:m] = np.clip(self.world.base_level[ids] + shift, 0, 7).astype(np.int32)
        xy[:m, 0] = u[ids] + self.rng.normal(0, self.px_noise, m)
        xy[:m, 1] = v[ids] + self.rng.normal(0, self.px_noise, m)
        desc[:m] = self.world.desc[ids]
        if self.bit_noise > 0:
            flip_bits = self.rng.integers(0, 256, (m, self.bit_noise))
            for q in range(m):
                for b in flip_bits[q]:
                    desc[q, b // 8] ^= 1 << (b % 8)
        valid[:m] = True
        slot_lm = np.full(N, -1, np.int64)
        slot_lm[:m] = ids
        self.slot_lm_by_frame[k] = slot_lm
        return self._features(xy, np.full(N, 30.0, np.float32), octv, desc, valid)

    def _features(self, xy, response, octave, desc, valid) -> FrameFeatures:
        def dev(a):
            return torch.from_numpy(a[None]).to(self.device)

        return FrameFeatures(xy=dev(xy), response=dev(response),
                             angle=dev(np.zeros(len(xy), np.float32)), octave=dev(octave),
                             desc=dev(desc), valid=dev(valid))


def frame_image(k: int, h: int = 480, w: int = 640) -> np.ndarray:
    """The placeholder 'image' carrying the frame index for GeoExtractor."""
    img = np.zeros((h, w), np.float32)
    img[0, 0] = k
    return img
