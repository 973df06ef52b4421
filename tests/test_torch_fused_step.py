"""Port parity: the fused tracking step (models/fused_track.py) and the
device map pool (models/device_map.py).

A short JAX MonoSLAM run on the geometric frontend (tests/test_fused.py's
GeoExtractor world) leaves a map and a tracker in the fused state. The port
gets that exact state through utils/convert.py (`map_from_reference`,
`features_from_numpy`), gathers the same local-map rows from its own pool,
and runs its fused step on the same inputs as the JAX step.

Match indices, masks and counts must be exact: every matching decision is
integer Hamming arithmetic and the two pose solves agree to f32 rounding far
from their chi2 gates. R and t agree within 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models.device_map import _pool_gather as jax_pool_gather
from ceres_mono_orb_slam2_tpu.models.fused_track import pack_control as jax_pack_control
from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes
from ceres_mono_orb_slam2_tpu.utils.geosim import GeoExtractor, GeoWorld, frame_image, make_geo_trajectory
from ceres_mono_orb_slam2_tpu_torch.models.device_map import DeviceMapPool
from ceres_mono_orb_slam2_tpu_torch.models.fused_track import FusedStep, pack_control, unpack_control
from ceres_mono_orb_slam2_tpu_torch.models.map import Map
from ceres_mono_orb_slam2_tpu_torch.utils.convert import (
    config_from_reference, features_from_numpy, map_from_reference)

torch.set_num_threads(2)
H, W, N_FEAT = 480, 640, 600


@pytest.fixture(scope="module")
def jax_state():
    cfg = SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=N_FEAT),
        shapes=StaticShapes(max_local_points=1024, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096),
    )
    n_frames = 14
    Rcw, tcw = make_geo_trajectory(n_frames + 1, "strafe")
    slam = JaxSLAM(cfg)
    slam.tracker.extractor = GeoExtractor(GeoWorld(np.random.default_rng(0), 2500), cfg.camera.K,
                                          Rcw, tcw, N_FEAT, H, W, px_noise=0.3, bit_noise=2, seed=3)
    for k in range(n_frames):
        slam.track_monocular(frame_image(k, H, W), k / 30.0)
    tr = slam.tracker
    assert tr._can_fuse() and tr.n_fused_frames > 0
    image = frame_image(n_frames, H, W)
    args, aux = tr._fused_prepare(image, n_frames / 30.0)
    feats = jax.tree_util.tree_map(lambda a: a[0], tr.extractor.extract(image))
    return cfg, slam, args, aux, feats


def test_fused_step_parity(jax_state):
    cfg, slam, args, aux, feats = jax_state
    tr = slam.tracker
    (_, last_oct, last_angle, last_desc, _, pool_dev, bounds) = args
    (_, lf, pool, _, slots, slots_padded, _, ids_snap, raw) = aux
    last_pos, last_ok, last_local_row, R_pred, t_pred, th_local = raw
    lblock_j = jax_pool_gather(*pool_dev, jnp.asarray(slots_padded))
    out_j = tr._fused_step(feats.xy, feats.octave, feats.angle, feats.desc, feats.valid,
                           last_oct, last_angle, last_desc, jnp.asarray(last_pos),
                           jnp.asarray(last_ok), jnp.asarray(last_local_row), jnp.asarray(R_pred),
                           jnp.asarray(t_pred), *lblock_j, bounds, th_local)

    # the port's pool over the converted map, gathered by the same point ids
    pmap = map_from_reference(slam.map)
    ppool = DeviceMapPool(pmap, cap=pool.cap, device="cpu")
    ppool.sync()
    L = len(slots_padded)
    pslots = np.full(L, ppool.cap, np.int64)
    pslots[:len(slots)] = ppool.slots_for_ids(ids_snap[:len(slots)])
    assert (pslots[:len(slots)] >= 0).all()
    lblock_t = ppool.gather(pslots)
    for a, b in zip(lblock_j, lblock_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    cur = features_from_numpy(*(np.asarray(a) for a in feats))
    step = FusedStep(config_from_reference(cfg), device="cpu")
    out_t = step(cur.xy, cur.octave, cur.angle, cur.desc, cur.valid,
                 T(last_oct), T(last_angle), T(last_desc), T(last_pos), T(last_ok),
                 T(last_local_row), T(R_pred), T(t_pred), *lblock_t, T(bounds), torch.tensor(float(th_local)))

    for name in ("m1_idx", "m1_valid", "inl1", "n1_matches", "n1_inliers", "m2_idx",
                 "m2_valid", "visible", "assoc", "inl2", "n2_inliers", "ok_next",
                 "next_local_row", "und"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)), err_msg=name)
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=1e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=1e-4)
    assert int(out_t.n2_inliers) > 100  # a real tracking frame, not a degenerate one

    # the packed control copy carries the same bits past its float header
    packed_t = pack_control(out_t, cur.valid).numpy()
    packed_j = np.asarray(jax_pack_control(out_j, feats.valid))
    np.testing.assert_array_equal(packed_t[12:], packed_j[12:])
    R, t, *rest = unpack_control(packed_t, L)
    np.testing.assert_array_equal(R, out_t.R.numpy())
    np.testing.assert_array_equal(rest[0], out_t.m1_idx.numpy())


def test_map_from_reference(jax_state):
    _, slam, _, _, _ = jax_state
    ref = slam.map
    m = map_from_reference(ref)
    assert m.n_keyframes() == ref.n_keyframes() and m.n_map_points() == ref.n_map_points()
    for kid, kf in ref.keyframes.items():
        pk = m.keyframes[kid]
        np.testing.assert_array_equal(pk.mp_ids, kf.mp_ids)
        np.testing.assert_array_equal(pk.desc, kf.desc)
        assert pk.ordered_neighbors == kf.ordered_neighbors and pk.parent == kf.parent
    for mp in ref.all_map_points():
        pm = m.map_points[mp.id]
        np.testing.assert_array_equal(pm.pos, mp.pos)
        np.testing.assert_array_equal(pm.descriptor, mp.descriptor)
        assert pm.observations == mp.observations
        assert pm.max_dist == mp.max_dist


def test_device_pool_incremental_sync(rng):
    """Mirror of tests/test_fused.py::test_device_pool_incremental_sync on
    the port's pool: growth, churn and an epoch reset keep the device rows
    equal to the host map."""
    m = Map()
    mps = []
    for _ in range(40):
        mp = m.new_map_point(rng.standard_normal(3).astype(np.float32),
                             rng.integers(0, 256, 32, dtype=np.uint8), ref_kf_id=0)
        mp.normal = rng.standard_normal(3).astype(np.float32)
        mp.min_dist, mp.max_dist = 1.0, 4.0
        mps.append(mp)
    pool = DeviceMapPool(m, cap=16, device="cpu")  # forces growth
    pool.sync()

    def check():
        pos, normal, mind, maxd, desc, valid = [a.numpy() for a in pool.dev]
        live = {mp.id: mp for mp in m.all_map_points()}
        n_valid = 0
        for s in range(pool.cap):
            if valid[s]:
                n_valid += 1
                mp = live[int(pool.id_of[s])]
                np.testing.assert_allclose(pos[s], mp.pos, rtol=1e-6)
                np.testing.assert_array_equal(desc[s], mp.descriptor)
                np.testing.assert_allclose(normal[s], mp.normal, rtol=1e-6)
        assert n_valid == len(live)
        assert not valid[pool.cap]  # scratch row never valid

    check()
    assert pool.n_grows >= 1
    for mp in mps[:10]:
        mp.pos = mp.pos + 1.0
        m.note_mp_dirty(mp.id)
    for mp in mps[10:15]:
        m.set_bad_map_point(mp)
    for _ in range(20):
        m.new_map_point(rng.standard_normal(3).astype(np.float32),
                        rng.integers(0, 256, 32, dtype=np.uint8), ref_kf_id=0)
    pool.sync()
    check()
    m.clear()
    for _ in range(5):
        m.new_map_point(rng.standard_normal(3).astype(np.float32),
                        rng.integers(0, 256, 32, dtype=np.uint8), ref_kf_id=0)
    pool.sync()
    check()
