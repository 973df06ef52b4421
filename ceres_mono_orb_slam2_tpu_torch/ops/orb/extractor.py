"""ORB feature extraction: batched, static per-level keypoint budgets.

Port of `ceres_mono_orb_slam2_tpu/ops/orb/extractor.py`: an 8-level pyramid,
FAST with the two-threshold per-cell rule, per-cell top-k + rank-major global
top-N (the octree's spatial uniformity), IC-angle orientation, 7x7 blur and
rBRIEF with the bit_pattern_31 table quantised to 30 rotation bins.

The pyramid is built level by level into one packed (B, total) float32
buffer (`kernels.PyramidLayout`: level l is the contiguous (H_l, W_l) plane
at `offsets[l]` of each row), with its 7x7-blurred, 8-bit-rounded copy in a
second buffer of the same layout. FAST+NMS then runs once over the whole
packed pyramid and the patch gathers once over all levels and both patch
sets: on a CUDA tensor one launch each of the kernels of `ops/orb/kernels.py`,
on a CPU tensor their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels
from ceres_mono_orb_slam2_tpu_torch.ops.orb.kernels import DESC_R, EDGE
from ceres_mono_orb_slam2_tpu_torch.ops.orb.pattern import BIT_PATTERN_31
from ceres_mono_orb_slam2_tpu_torch.utils.config import ORBConfig
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

CELL = 32  # spatial-uniformity cell size
TOP_PER_CELL = 8  # candidates kept per cell before the rank-major global top-N
N_ANGLE_BINS = 30  # rBRIEF rotation quantisation (12 deg)


class FrameFeatures(NamedTuple):
    """SoA keypoint/descriptor tensors for a batch of frames: (B, N, ...)
    with N = n_features, unfilled slots masked by `valid`."""

    xy: torch.Tensor  # (B, N, 2) float32, level-0 pixel coords (distorted)
    response: torch.Tensor  # (B, N) float32 FAST score
    angle: torch.Tensor  # (B, N) float32 radians
    octave: torch.Tensor  # (B, N) int32 pyramid level
    desc: torch.Tensor  # (B, N, 32) uint8 packed rBRIEF
    valid: torch.Tensor  # (B, N) bool


def _level_sizes(h: int, w: int, n_levels: int, scale: float):
    return [(int(round(h / scale ** lv)), int(round(w / scale ** lv)))
            for lv in range(n_levels)]


def bin_tap_table() -> np.ndarray:
    """(N_ANGLE_BINS, 512) flat indices into the 39x39 descriptor patch of the
    rotated bit_pattern_31 taps, one row per 12-degree rotation bin."""
    pts = BIT_PATTERN_31.reshape(512, 2).astype(np.float64)
    side = 2 * DESC_R + 1
    tables = []
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pts[:, 0] * ca - pts[:, 1] * sa).astype(np.int32)
        ry = np.round(pts[:, 0] * sa + pts[:, 1] * ca).astype(np.int32)
        tables.append((ry + DESC_R) * side + (rx + DESC_R))
    return np.stack(tables)


def _select_level_keypoints(score: torch.Tensor, n_keep: int, ini_th: float, min_th: float):
    """Two-threshold per-cell candidates + rank-major global top-N.

    score: (B, H, W) NMS'd FAST score (margins zeroed).
    Returns (ys, xs, resp, valid), each (B, n_keep).
    """
    B, H, W = score.shape
    dev = score.device
    sp = torch.nn.functional.pad(score, (0, -W % CELL, 0, -H % CELL))
    Hp, Wp = sp.shape[-2:]
    ncy, ncx = Hp // CELL, Wp // CELL
    cells = sp.reshape(B, ncy, CELL, ncx, CELL).permute(0, 1, 3, 2, 4).reshape(
        B, ncy * ncx, CELL * CELL)

    # per-cell two-threshold rule: the high threshold, or the low one in a
    # cell with no high-threshold corner
    cell_max = cells.amax(-1, keepdim=True)
    keep = (cells > ini_th) | ((cell_max <= ini_th) & (cells > min_th))
    work = torch.where(keep, cells, torch.zeros_like(cells))

    # top-m per cell by m rounds of (argmax, mask); argmax returns the first
    # maximal index, so ties go to the lower index like a stable sort
    vals_l, idx_l = [], []
    for _ in range(TOP_PER_CELL):
        i = work.argmax(-1)
        vals_l.append(work.amax(-1))
        idx_l.append(i)
        work = work.scatter(-1, i[..., None], -1.0)
    vals = torch.stack(vals_l, -1)  # (B, nc, m), descending
    idx = torch.stack(idx_l, -1).to(torch.int32)
    cell_ids = torch.arange(ncy * ncx, dtype=torch.int32, device=dev)
    cy = (cell_ids // ncx)[None, :, None]
    cx = (cell_ids % ncx)[None, :, None]
    ys = cy * CELL + idx // CELL
    xs = cx * CELL + idx % CELL
    rank = torch.arange(TOP_PER_CELL, dtype=torch.float32, device=dev)[None, None, :]

    # rank-major key: every cell's best before any cell's second best, ties
    # by response; smallest keys win, equal keys in index order (the order of
    # lax.top_k), hence the stable sort
    valid = vals > 0.0
    key = torch.where(valid, rank * 1e4 + (512.0 - vals.clamp_max(500.0)),
                      torch.full_like(vals, 1e9)).reshape(B, -1)
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    flat_sel = order[:, :n_keep]
    sel_valid = key_sorted[:, :n_keep] < 1e8
    ys = torch.gather(ys.reshape(B, -1), 1, flat_sel)
    xs = torch.gather(xs.reshape(B, -1), 1, flat_sel)
    resp = torch.gather(vals.reshape(B, -1), 1, flat_sel)
    return ys, xs, resp, sel_valid


class ORBExtractor(nn.Module):
    """Batched ORB extractor; `extract(images)` takes (B, H, W) or (H, W)
    uint8/float images (numpy or tensors) and returns FrameFeatures on
    `device`. The rBRIEF tap table and IC moment masks are buffers."""

    def __init__(self, config: ORBConfig, device=DEFAULT_DEVICE):
        super().__init__()
        self.config = config
        self.features_per_level = [int(n) for n in config.features_per_level]
        self.scale_factors = [float(s) for s in config.scale_factors]
        mx, my = kernels.ic_angle_mask()
        self.register_buffer("tap_table", torch.as_tensor(bin_tap_table(), dtype=torch.long))
        self.register_buffer("moment_masks", torch.as_tensor(
            np.stack([mx.reshape(-1), my.reshape(-1)], axis=1), dtype=torch.float32))
        self.register_buffer("byte_weights", torch.as_tensor(
            1 << np.arange(8), dtype=torch.int32))
        self.to(resolve_device(device))
        self._slot_tables = {}  # per-level keypoint counts -> (level, scale) per slot

    @property
    def device(self) -> torch.device:
        return self.tap_table.device

    def pyramid(self, images: torch.Tensor):
        """(B, h, w) float32 -> (layout, raw, blurred): the packed pyramid
        (each level the antialiased bilinear resize of the one before) and
        its 7x7 blur rounded to the 8-bit grid (the reference blurs into an
        8-bit Mat and compares integers)."""
        cfg = self.config
        B, h, w = images.shape
        layout = kernels.PyramidLayout.of(_level_sizes(h, w, cfg.n_levels, cfg.scale_factor))
        raw = torch.empty((B, layout.total), dtype=torch.float32, device=images.device)
        blurred = torch.empty_like(raw)
        raw_l = layout.views(raw)
        raw_l[0].copy_(images)
        for lv in range(1, cfg.n_levels):
            raw_l[lv].copy_(kernels.resize_bilinear(raw_l[lv - 1], *layout.shapes[lv]))
        for src, dst in zip(raw_l, layout.views(blurred)):
            torch.floor(kernels.gaussian_blur7(src) + 0.5, out=dst).clamp_(0.0, 255.0)
        return layout, raw, blurred

    def detect(self, raw: torch.Tensor, layout):
        """FAST + NMS of all levels of the packed pyramid, the EDGE margin
        zeroed so that every kept keypoint admits full patches, then each
        level's keypoint selection. Returns level-major (B, N) ys, xs, resp,
        valid and the keypoint count of each level (its budget, or fewer on
        a level with fewer candidate slots)."""
        cfg = self.config
        score = kernels.fast_nms_pyramid(raw, layout, edge=EDGE)
        sel = [_select_level_keypoints(score_l, n_keep, cfg.ini_th_fast, cfg.min_th_fast)
               for score_l, n_keep in zip(layout.views(score), self.features_per_level)]
        counts = tuple(s[0].shape[1] for s in sel)
        return (*(torch.cat([s[i] for s in sel], 1) for i in range(4)), counts)

    def slot_tables(self, counts: tuple):
        """(N,) int32 level and (N,) float32 level-0 scale of each keypoint
        slot for these per-level counts, built once per count tuple."""
        tables = self._slot_tables.get(counts)
        if tables is None:
            level = np.repeat(np.arange(len(counts)), counts)
            tables = (torch.as_tensor(level, dtype=torch.int32, device=self.device),
                      torch.as_tensor(np.float32(self.scale_factors)[level], device=self.device))
            self._slot_tables[counts] = tables
        return tables

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> FrameFeatures:
        """images: (B, H, W) uint8 tensor on this extractor's device."""
        images = images.to(torch.float32)
        B = images.shape[0]
        layout, raw, blurred = self.pyramid(images)
        ys, xs, resp, valid, counts = self.detect(raw, layout)
        safe_y = torch.where(valid, ys, EDGE).to(torch.int32).contiguous()
        safe_x = torch.where(valid, xs, EDGE).to(torch.int32).contiguous()
        # raw patches for the IC angle (orientation is computed pre-blur),
        # 8-bit blurred ones for rBRIEF
        p31, pf8 = kernels.gather_pyramid_patches(raw, blurred, layout, safe_y, safe_x, counts)
        level, scale = self.slot_tables(counts)
        xy = torch.stack([xs, ys], dim=-1).to(torch.float32) * scale[:, None]
        octave = level.expand(B, -1).contiguous()
        N = p31.shape[1]

        # IC angle: one moment product over all keypoints of the frame
        m_both = p31.reshape(B * N, -1) @ self.moment_masks  # (B*N, 2)
        angle = torch.atan2(m_both[:, 1], m_both[:, 0])

        # rBRIEF on the 8-bit patch, with the tap table of the keypoint's
        # rotation bin
        pf8 = pf8.reshape(B * N, -1)
        two_pi = 2.0 * np.pi
        bin_idx = torch.round(torch.remainder(angle, two_pi) / (two_pi / N_ANGLE_BINS))
        bin_idx = torch.remainder(bin_idx.to(torch.int64), N_ANGLE_BINS)
        sel = torch.gather(pf8, 1, self.tap_table[bin_idx])  # (B*N, 512)
        bits = (sel[:, 0::2] < sel[:, 1::2]).to(torch.int32).reshape(B * N, 32, 8)
        desc = (bits * self.byte_weights).sum(-1).to(torch.uint8).reshape(B, N, 32)
        return FrameFeatures(xy=xy, response=resp, angle=angle.reshape(B, N),
                             octave=octave, desc=desc, valid=valid)

    def extract(self, images) -> FrameFeatures:
        """images: (B, H, W) or (H, W) grayscale in [0, 255]. Float input is
        quantised to uint8 on entry with the rounding the tracker uses, so
        every door into the pipeline sees one 8-bit pixel representation."""
        if isinstance(images, torch.Tensor):
            if images.dim() == 2:
                images = images[None]
            if images.dtype != torch.uint8:
                images = (images.float() + 0.5).clamp(0.0, 255.0).to(torch.uint8)
            return self(images.to(self.device))
        images = np.asarray(images)
        if images.ndim == 2:
            images = images[None]
        if images.dtype != np.uint8:
            images = np.clip(images + 0.5, 0.0, 255.0).astype(np.uint8)
        return self(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
