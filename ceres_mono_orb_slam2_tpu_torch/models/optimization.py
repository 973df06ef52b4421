"""Host wrappers assembling map state into optimizer calls.

Port of `ceres_mono_orb_slam2_tpu/models/optimization.py`:
`global_bundle_adjustment` (the two-view initializer's full BA) and
`run_global_ba` (the loop closer's global BA with side-field results and
spanning-tree propagation). Problems are solved at their actual size: there
is no compiler whose shape family padding would bound.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.ops import optim
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# past this many pose-point block pairs the dense Schur's (M, P, 6, 3) cross
# tensor stops fitting comfortably and the matrix-free CG solver takes over
DENSE_BA_MAX_BLOCKS = 1 << 21


def _whole_map_problem(m, config, device):
    """The BA problem over every keyframe and map point, on `device`, or
    None when the map has too few observations to solve: (kfs, mps, kf_slot,
    mp_slot, fixed (numpy; the first keyframe fixes the gauge), K, R, t,
    points, obs_pose, obs_point, obs_uv, obs_inv_sigma2, obs_valid,
    point_valid)."""
    kfs = m.all_keyframes()
    mps = m.all_map_points()
    if not kfs or not mps:
        return None
    inv_sigma2 = config.orb.inv_level_sigma2
    kf_slot = {kf.id: i for i, kf in enumerate(kfs)}
    mp_slot = {mp.id: i for i, mp in enumerate(mps)}
    obs = []
    for mp in mps:
        for kf_id, kidx in mp.observations.items():
            kf = m.keyframes.get(kf_id)
            if kf is None or kf.bad:
                continue
            obs.append((kf_slot[kf_id], mp_slot[mp.id], kf.kp_und[kidx],
                        inv_sigma2[kf.kp_octave[kidx]]))
    if len(obs) < 10:
        return None
    fixed = np.zeros(len(kfs), bool)
    fixed[kf_slot[min(kf.id for kf in kfs)]] = True

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    tensors = (
        dev(config.camera.K, np.float32),
        dev(np.stack([kf.Rcw for kf in kfs]), np.float32),
        dev(np.stack([kf.tcw for kf in kfs]), np.float32),
        dev(np.stack([mp.pos for mp in mps]), np.float32),
        dev([o[0] for o in obs], np.int64), dev([o[1] for o in obs], np.int64),
        dev(np.stack([o[2] for o in obs]), np.float32),
        dev([o[3] for o in obs], np.float32),
        torch.ones(len(obs), dtype=torch.bool, device=device),
        torch.ones(len(mps), dtype=torch.bool, device=device),
    )
    return kfs, mps, kf_slot, mp_slot, fixed, tensors


def run_global_ba(m, config, loop_kf_id: int, n_iters: int = 50, stop_cb=None,
                  chunk: int = 10, robust: bool = True, force_cg: bool = False,
                  device=DEFAULT_DEVICE, stats: dict = None, robust_step=None,
                  trimmed_step=None, cg_step=None):
    """Reference RunGlobalBundleAdjustment (LoopClosing.cc:646-739): global BA
    over a snapshot of the map with cooperative abort, side-field results,
    then spanning-tree propagation to keyframes and map points created while
    the solve ran (possible only with a mapping thread; otherwise nothing is
    added).

    The reference aborts Ceres between iterations through a callback; here
    the LM loop runs in `chunk`-iteration solver calls and `stop_cb()` is
    checked between chunks, on the thread that solves (the loop closer's
    `gba` thread in threaded mode; the flags it reads are set by the loop
    closer's own thread). The map lock is held only for the snapshot and
    the apply, never during the solve. Past `DENSE_BA_MAX_BLOCKS` pose-point pairs, or
    with `force_cg`, the matrix-free CG solver replaces the dense Schur one.
    `stats`, when given, receives P, M, O and the solver taken.
    `robust_step` / `trimmed_step` run one iteration of the dense solver
    (`optim.bundle_adjustment`'s) and `cg_step` one of the robust CG solver
    (`optim.cg_lm_iteration`); `LoopClosing` passes captured programs,
    which every chunk replays.

    Returns True if the solve completed and was applied."""
    device = resolve_device(device)
    with m.update_lock:
        prob = _whole_map_problem(m, config, device)
    if prob is None:
        return False
    kfs, mps, kf_slot, mp_slot, fixed, (K, R, t, pts, op, oj, ouv, ow, ovalid, pvalid) = prob
    P, M = len(kfs), len(mps)
    use_cg = force_cg or P * M > DENSE_BA_MAX_BLOCKS
    if stats is not None:
        stats.update(P=P, M=M, O=int(op.shape[0]), solver="cg" if use_cg else "dense")
    jfixed = torch.as_tensor(fixed, device=device)
    done = 0
    while done < n_iters:
        it = min(chunk, n_iters - done)
        if use_cg:
            res = optim.bundle_adjustment_cg(K, R, t, pts, op, oj, ouv, ow, ovalid, jfixed, pvalid,
                                             iters=it, cg_iters=optim.CG_ITERS, robust=robust,
                                             step=cg_step if robust else None)
        else:
            res = optim.bundle_adjustment(K, R, t, pts, op, oj, ouv, ow, ovalid, jfixed, pvalid,
                                          iters_huber=it if robust else 0,
                                          iters_trimmed=0 if robust else it,
                                          robust_step=robust_step, trimmed_step=trimmed_step)
        R, t, pts = res.R, res.t, res.points
        done += it
        if stop_cb is not None and stop_cb():
            return False  # aborted: discard

    Rn, tn, ptsn = graphs.fetch(R, t, pts)
    with m.update_lock:
        # side fields for the keyframes of the snapshot
        for kf_id, i in kf_slot.items():
            kf = m.keyframes.get(kf_id)
            if kf is None:
                continue
            kf.Tcw_gba = (Rn[i], tn[i])
            kf.gba_for_kf = loop_kf_id
        # spanning-tree propagation from the map origins (LoopClosing.cc:679-713)
        stack = [m.keyframes[k] for k in m.keyframe_origins if k in m.keyframes]
        gba_bef = {}
        while stack:
            kf = stack.pop(0)
            if kf.Tcw_gba is None:
                continue
            Rwc, twc = kf.Rcw.T, -kf.Rcw.T @ kf.tcw
            for ch_id in kf.children:
                ch = m.keyframes.get(ch_id)
                if ch is None or ch.bad:
                    continue
                if ch.gba_for_kf != loop_kf_id:
                    # T_child_c = T_child Twc(parent); Tcw_gba = T_child_c * parent's
                    Rrel = ch.Rcw @ Rwc
                    trel = ch.Rcw @ twc + ch.tcw
                    Rp, tp_ = kf.Tcw_gba
                    ch.Tcw_gba = (Rrel @ Rp, Rrel @ tp_ + trel)
                    ch.gba_for_kf = loop_kf_id
                stack.append(ch)
            gba_bef[kf.id] = (kf.Rcw.copy(), kf.tcw.copy())
            kf.Rcw, kf.tcw = (kf.Tcw_gba[0].astype(np.float32),
                              kf.Tcw_gba[1].astype(np.float32))
        # map points: solved ones directly, new ones through their reference KF
        for mp in m.all_map_points():
            i = mp_slot.get(mp.id)
            if i is not None:
                mp.pos = ptsn[i]
            else:
                ref = m.keyframes.get(mp.ref_kf_id)
                if ref is None or ref.id not in gba_bef:
                    continue
                Ro, to = gba_bef[ref.id]
                Xc = Ro @ mp.pos + to
                mp.pos = (ref.Rcw.T @ (Xc - ref.tcw)).astype(np.float32)
        m.note_all_mp_dirty()  # device pools must re-mirror every position
        m.big_change_idx += 1
    return True


def global_bundle_adjustment(m, config, n_iters: int = 20, fixed_kf_ids=None,
                             device=DEFAULT_DEVICE, robust_step=None):
    """Full Huber-robust BA over the whole map (GlobalBundleAdjustemnt),
    applied in place. The first keyframe (or `fixed_kf_ids`) fixes the gauge.
    Returns False when the map has too few observations to solve. It does
    not bump `big_change_idx`: the two-view initializer calls it, and
    `map_changed()` must not report initialisation. `robust_step` runs each
    LM iteration (`optim.bundle_adjustment`'s; `Tracking` passes its
    captured `optim.lm_iteration_robust`)."""
    device = resolve_device(device)
    prob = _whole_map_problem(m, config, device)
    if prob is None:
        return False
    kfs, mps, kf_slot, mp_slot, fixed, (K, R, t, pts, op, oj, ouv, ow, ovalid, pvalid) = prob
    if fixed_kf_ids is not None:
        fixed = np.zeros(len(kfs), bool)
        for fid in fixed_kf_ids:
            if fid in kf_slot:
                fixed[kf_slot[fid]] = True
    # Huber-robust iterations like the reference (is_robust=true): a trimmed
    # pass would chi2-trim at the initial state and drop exactly the
    # observations a far-from-optimum map needs
    res = optim.bundle_adjustment(K, R, t, pts, op, oj, ouv, ow, ovalid,
                                  torch.as_tensor(fixed, device=device), pvalid,
                                  iters_huber=n_iters, iters_trimmed=0, robust_step=robust_step)
    Rn, tn, ptsn = graphs.fetch(res.R, res.t, res.points)
    for kf in kfs:
        s = kf_slot[kf.id]
        if not fixed[s]:
            kf.Rcw = Rn[s]
            kf.tcw = tn[s]
    for mp in mps:
        mp.pos = ptsn[mp_slot[mp.id]]
    m.note_all_mp_dirty()
    return True
