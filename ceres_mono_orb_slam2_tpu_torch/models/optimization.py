"""Host wrappers assembling map state into optimizer calls.

Port of `global_bundle_adjustment` from
`ceres_mono_orb_slam2_tpu/models/optimization.py` (the two-view initializer's
full BA). `run_global_ba` waits for the loop-closing port. Problems are
solved at their actual size: there is no compiler whose shape family padding
would bound.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.ops import optim
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def global_bundle_adjustment(m, config, n_iters: int = 20, fixed_kf_ids=None,
                             device=DEFAULT_DEVICE):
    """Full Huber-robust BA over the whole map (GlobalBundleAdjustemnt),
    applied in place. The first keyframe (or `fixed_kf_ids`) fixes the gauge.
    Returns False when the map has too few observations to solve."""
    device = resolve_device(device)
    kfs = m.all_keyframes()
    mps = m.all_map_points()
    if not kfs or not mps:
        return False
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
        return False
    P, M = len(kfs), len(mps)
    fixed = np.zeros(P, bool)
    if fixed_kf_ids is None:
        fixed_kf_ids = [min(kf.id for kf in kfs)]
    for fid in fixed_kf_ids:
        if fid in kf_slot:
            fixed[kf_slot[fid]] = True

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    # Huber-robust iterations like the reference (is_robust=true): a trimmed
    # pass would chi2-trim at the initial state and drop exactly the
    # observations a far-from-optimum map needs
    res = optim.bundle_adjustment(
        dev(config.camera.K, np.float32),
        dev(np.stack([kf.Rcw for kf in kfs]), np.float32),
        dev(np.stack([kf.tcw for kf in kfs]), np.float32),
        dev(np.stack([mp.pos for mp in mps]), np.float32),
        dev([o[0] for o in obs], np.int64), dev([o[1] for o in obs], np.int64),
        dev(np.stack([o[2] for o in obs]), np.float32),
        dev([o[3] for o in obs], np.float32),
        torch.ones(len(obs), dtype=torch.bool, device=device), dev(fixed),
        torch.ones(M, dtype=torch.bool, device=device),
        iters_huber=n_iters, iters_trimmed=0,
    )
    Rn, tn, ptsn = (a.cpu().numpy() for a in (res.R, res.t, res.points))
    for kf in kfs:
        s = kf_slot[kf.id]
        if not fixed[s]:
            kf.Rcw = Rn[s]
            kf.tcw = tn[s]
    for mp in mps:
        mp.pos = ptsn[mp_slot[mp.id]]
    m.note_all_mp_dirty()
    return True
