"""Fused per-frame tracking step: the normal-state hot loop.

Port of `ceres_mono_orb_slam2_tpu/models/fused_track.py` as an `nn.Module`
whose constant tables (K, scale factors, inverse level sigma^2, distortion)
are buffers:

    [ motion-model projection match (15 px window, 30 px when it finds
      fewer than 20 matches) -> trimmed-LM pose solve
      -> frustum + scale prediction over the local-map block
      -> local projection match -> trimmed-LM pose solve ]

Everything the host needs back is packed by `pack_control` into one int32
tensor, copied to the host once per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ceres_mono_orb_slam2_tpu_torch.ops import camera, frustum, lie, matcher, optim
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class FusedOut(NamedTuple):
    """Outputs of one fused step. With a leading stream axis on the inputs
    every field carries it too: (S, ...) before the shapes below."""

    R: torch.Tensor  # (3,3) final pose
    t: torch.Tensor  # (3,)
    und: torch.Tensor  # (N,2) undistorted current keypoints
    m1_idx: torch.Tensor  # (N,) per-LAST-slot matched current kp
    m1_valid: torch.Tensor  # (N,)
    inl1: torch.Tensor  # (N,) per-kp stage-1 inliers
    n1_matches: torch.Tensor  # () motion-model match count
    n1_inliers: torch.Tensor  # ()
    m2_idx: torch.Tensor  # (L,) per-local-row matched current kp
    m2_valid: torch.Tensor  # (L,)
    visible: torch.Tensor  # (L,) frustum-visible local rows
    assoc: torch.Tensor  # (N,) kp slot bound after both stages
    inl2: torch.Tensor  # (N,) final inlier mask
    n2_inliers: torch.Tensor  # ()
    pos_kp: torch.Tensor  # (N,3) bound 3D point per kp slot
    ok_next: torch.Tensor  # (N,) inlier-bound slots (the next frame's last_ok)
    next_local_row: torch.Tensor  # (N,) local-block row of the bound point (-1 none)

    def stream(self, s: int) -> "FusedOut":
        """Stream s of a batched result (views, no copy)."""
        return FusedOut(*(a[s] for a in self))


CTL_HEADER = 15  # R+t (12) + 3 counters


def pack_control(out: FusedOut, feats_valid: torch.Tensor) -> torch.Tensor:
    """Every host-bound control output in ONE int32 tensor (one device to
    host copy per frame, or per batch of frames: a batched `out` packs to
    (S, 15 + N + L)). Layout:
      [0:12]        R (9) + t (3), f32 bit pattern
      [12:15]       n1_matches, n1_inliers, n2_inliers
      [15:15+N]     per keypoint: m1_idx | m1_valid<<16 | inl1<<17
                    | assoc<<18 | inl2<<19 | feats_valid<<20
      [15+N:15+N+L] per local row: m2_idx | m2_valid<<16 | visible<<17
    Index fields are < N <= 65535."""
    i32 = torch.int32
    kp = (out.m1_idx.to(i32) | (out.m1_valid.to(i32) << 16) | (out.inl1.to(i32) << 17)
          | (out.assoc.to(i32) << 18) | (out.inl2.to(i32) << 19)
          | (feats_valid.to(i32) << 20))
    loc = out.m2_idx.to(i32) | (out.m2_valid.to(i32) << 16) | (out.visible.to(i32) << 17)
    hdr = torch.cat([out.R.reshape(out.t.shape[:-1] + (9,)), out.t], -1).to(torch.float32).view(i32)
    cnt = torch.stack([out.n1_matches, out.n1_inliers, out.n2_inliers], -1).to(i32)
    return torch.cat([hdr, cnt, kp, loc], -1)


def unpack_control(packed: np.ndarray, L: int):
    """Host inverse of pack_control for one frame: (R, t, m1_idx, m1_valid,
    inl1, n1, ninl1, m2_idx, m2_valid, visible, assoc, inl2, ninl2,
    feats_valid)."""
    hdr = packed[:12].view(np.float32)
    R = hdr[:9].reshape(3, 3).copy()
    t = hdr[9:12].copy()
    n1, ninl1, ninl2 = int(packed[12]), int(packed[13]), int(packed[14])
    kp = packed[CTL_HEADER:len(packed) - L]
    loc = packed[len(packed) - L:]
    bit = lambda a, k: (a >> k & 1).astype(bool)  # noqa: E731
    return (R, t, (kp & 0xFFFF).astype(np.int32), bit(kp, 16), bit(kp, 17), n1, ninl1,
            (loc & 0xFFFF).astype(np.int32), bit(loc, 16), bit(loc, 17),
            bit(kp, 18), bit(kp, 19), ninl2, bit(kp, 20))


def chained_prediction(pR: torch.Tensor, pt: torch.Tensor, ppR: torch.Tensor, ppt: torch.Tensor):
    """Constant-velocity prediction of a chained (pipelined) frame from the
    two previous poses, on the device: Rv = pR ppR^T, tv = pt - Rv ppt, then
    (Rv pR, Rv pt + tv). Both rotations are projected onto SO(3), which
    keeps the composition from compounding f32 determinant drift. Returns
    (R_pred (3, 3), t_pred (3,))."""
    Rv = lie.so3_project(pR @ ppR.transpose(-1, -2))
    tv = pt - Rv @ ppt
    return lie.so3_project(Rv @ pR), Rv @ pt + tv


def _scatter_rows(n: int, idx_safe: torch.Tensor, src: torch.Tensor, fill):
    """out[..., idx_safe[..., i], :] = src[..., i, :] into a buffer of n + 1
    rows whose last row absorbs invalid entries (idx_safe == n); returns the
    first n rows. idx_safe is (..., Q) and src (..., Q) or (..., Q, C); valid
    entries of one leading index name distinct rows."""
    row_dim = idx_safe.dim() - 1
    trail = tuple(src.shape[idx_safe.dim():])
    out = torch.full(tuple(idx_safe.shape[:-1]) + (n + 1,) + trail, fill,
                     dtype=src.dtype, device=src.device)
    idx = idx_safe.reshape(idx_safe.shape + (1,) * len(trail)).expand(src.shape)
    out.scatter_(row_dim, idx, src)
    return out.narrow(row_dim, 0, n)


class FusedStep(nn.Module):
    """The fused step for one camera/ORB configuration; call it with the
    current frame's features, the last frame's, the motion prediction and
    the local-map block (see `forward`). Every per-frame argument may carry
    one leading stream axis: S frames of S independent streams then go
    through the same launches, each stream with its own pose solves.

    `pose_iters` (2, 4) int32, on the device: the LM iterations each round
    of the last call's two pose solves ran (`PoseOptResult.iters`; with a
    stream axis, the batch's), written by every call and replay."""

    def __init__(self, config, device=DEFAULT_DEVICE):
        super().__init__()
        cam = config.camera
        self.register_buffer("K", torch.as_tensor(cam.K, dtype=torch.float32))
        self.register_buffer("dist", torch.as_tensor(cam.dist_coeffs, dtype=torch.float32))
        self.has_distortion = bool(cam.has_distortion)
        self.register_buffer("scales", torch.as_tensor(config.orb.scale_factors, dtype=torch.float32))
        self.register_buffer("inv_sigma2", torch.as_tensor(
            config.orb.inv_level_sigma2.astype(np.float32)))
        self.log_scale = float(np.log(config.orb.scale_factor))
        self.n_levels = config.orb.n_levels
        self.register_buffer("pose_iters", torch.zeros((2, 4), dtype=torch.int32), persistent=False)
        self.to(resolve_device(device))

    def _match_motion(self, d, und, cur_oct, cur_angle, cur_valid, last_oct, last_angle,
                      pr_uv, pr_ok, th):
        """SearchByProjection against the last frame for one window width;
        `d` is the shared (..., N, N) Hamming matrix."""
        r = th * self.scales[last_oct]
        _, _, in_w = matcher._window(pr_uv, und, r)
        oct_c, oct_l = cur_oct[..., None, :], last_oct[..., None]
        lvl = (oct_c >= oct_l - 1) & (oct_c <= oct_l + 1)
        mask = in_w & lvl & cur_valid[..., None, :] & pr_ok[..., None]
        best_val, best_idx, _, _ = matcher.masked_top2(d, mask)
        valid = pr_ok & (best_val <= matcher.TH_HIGH)
        valid = matcher.rotation_consistency_mask(last_angle, cur_angle.gather(-1, best_idx), valid)
        valid = matcher.resolve_duplicate_targets(best_idx, best_val, valid, und.shape[-2])
        return best_idx, valid

    @torch.no_grad()
    def forward(self, cur_xy, cur_oct, cur_angle, cur_desc, cur_valid,
                last_oct, last_angle, last_desc, last_pos, last_ok, last_local_row,
                R_pred, t_pred, l_pos, l_normal, l_mind, l_maxd, l_desc, l_valid,
                bounds, th_local) -> FusedOut:
        """`th_local` is a float32 tensor: 0-d, or with a stream axis (S,)
        (a number would be frozen into a captured program, `utils/graphs.py`);
        `bounds` (4,) is shared by all streams."""
        if not torch.is_tensor(th_local):
            raise TypeError(f"FusedStep: th_local must be a tensor, got {type(th_local).__name__}")
        K = self.K
        N = cur_xy.shape[-2]
        L = l_pos.shape[-2]
        th_local = th_local[..., None]
        und = camera.undistort_points(cur_xy, K, self.dist) if self.has_distortion else cur_xy
        cur_bits = matcher.unpack_bits_pm1(cur_desc)
        w = self.inv_sigma2[cur_oct]

        # ---- stage 1: motion-model projection match + pose solve ----------
        Xc = last_pos @ R_pred.transpose(-1, -2) + t_pred[..., None, :]
        z = Xc[..., 2].clamp_min(1e-6)
        pr_uv = torch.stack([K[0, 0] * Xc[..., 0] / z + K[0, 2],
                             K[1, 1] * Xc[..., 1] / z + K[1, 2]], -1)
        pr_ok = last_ok & (Xc[..., 2] > 0)
        d1 = matcher.hamming_matrix(matcher.unpack_bits_pm1(last_desc), cur_bits)
        i15, v15 = self._match_motion(d1, und, cur_oct, cur_angle, cur_valid,
                                      last_oct, last_angle, pr_uv, pr_ok, 15.0)
        i30, v30 = self._match_motion(d1, und, cur_oct, cur_angle, cur_valid,
                                      last_oct, last_angle, pr_uv, pr_ok, 30.0)
        del d1
        n15 = v15.to(torch.int32).sum(-1)
        use15 = n15 >= 20  # the retry-wider gate
        m1_idx = torch.where(use15[..., None], i15, i30)
        m1_valid = torch.where(use15[..., None], v15, v30)
        n1 = torch.where(use15, n15, v30.to(torch.int32).sum(-1))

        safe1 = torch.where(m1_valid, m1_idx, N)
        pos1 = _scatter_rows(N, safe1, last_pos, 0.0)
        ok1 = _scatter_rows(N, safe1, m1_valid, False)
        res1 = optim.pose_optimization(K, R_pred, t_pred, pos1, und, w, ok1)
        inl1 = res1.inliers
        bound1 = ok1 & inl1

        # ---- stage 2: local-map frustum + match + pose solve --------------
        uv2, level2, viewcos2, visible = frustum.frustum_and_scale(
            res1.R, res1.t, K, bounds, l_pos, l_normal, l_mind, l_maxd, l_valid,
            self.log_scale, self.n_levels)
        # exclude local rows whose point is already bound through stage 1
        bound_last = m1_valid & inl1.gather(-1, m1_idx)
        rr = torch.where(bound_last & (last_local_row >= 0), last_local_row.long(), L)
        excl = _scatter_rows(L, rr, torch.ones_like(rr, dtype=torch.bool), False)
        cand_ok = visible & ~excl
        kp_free = cur_valid & ~bound1
        # SearchByProjection overload #1; th_local widens the radius to 5
        # right after a relocalization
        m2_idx, _, m2_valid = matcher.search_by_projection_points(
            und, cur_oct, cur_bits, cur_valid, kp_free, uv2, level2, viewcos2,
            matcher.unpack_bits_pm1(l_desc), cand_ok, self.scales, th=th_local)

        safe2 = torch.where(m2_valid, m2_idx, N)
        pos2 = _scatter_rows(N, safe2, l_pos, 0.0)
        ok_new = _scatter_rows(N, safe2, m2_valid, False)
        pos_kp = torch.where(bound1[..., None], pos1, pos2)
        assoc = bound1 | ok_new
        res2 = optim.pose_optimization(K, res1.R, res1.t, pos_kp, und, w, assoc)
        torch.stack([res1.iters, res2.iters], out=self.pose_iters)

        # chained next-frame state: what the host rebuilds for the next
        # frame's stage-1 inputs, minus the post-solve outliers
        ok_next = assoc & res2.inliers
        row1 = _scatter_rows(N, safe1, last_local_row.to(torch.int32), -1)
        rows = torch.arange(L, dtype=torch.int32, device=K.device).expand(safe2.shape)
        row2 = _scatter_rows(N, safe2, rows, -1)
        minus1 = torch.full_like(row1, -1)
        next_row = torch.where(ok_new, row2, torch.where(bound1, row1, minus1))
        next_row = torch.where(ok_next, next_row, minus1)
        return FusedOut(
            R=res2.R, t=res2.t, und=und,
            m1_idx=m1_idx, m1_valid=m1_valid, inl1=inl1,
            n1_matches=n1, n1_inliers=res1.n_inliers,
            m2_idx=m2_idx, m2_valid=m2_valid, visible=visible,
            assoc=assoc, inl2=res2.inliers, n2_inliers=res2.n_inliers,
            pos_kp=pos_kp, ok_next=ok_next, next_local_row=next_row,
        )
