"""Port parity of localization mode and map persistence (the save -> load ->
relocalize -> localize -> resume half of tests/test_relocalization.py, and
the savers of tests/test_slam_e2e.py).

Both packages map frames 0-10 of the seed-11 strafe with the same
vocabulary (trained on frame 0's descriptors), the port fed the JAX
tracker's RANSAC draws, and save their maps. Each package loads the JAX
file and the port's file: the loaded maps must agree exactly (counts, ids,
poses, payloads, bindings, covisibility, spanning tree, BoW index). Then
both load the JAX file, switch localization mode on, relocalize on frame
5's view, track frames 6-8 without a keyframe, switch it off and resume over
frames 9-14. The port's `load_map` leaves its tracker LOST; the JAX
tracker is set LOST by hand, as tests/test_relocalization.py does.

Stated bars, as tests/test_torch_reloc.py's: equal states frame by frame,
camera centres within 0.02 of each other; inlier counts within 10% of each
other (the two extractors' pyramid levels >= 1 differ by ~1e-2, which moves
borderline matches); the resumed trajectory's ATE under 2% of its length
(tests/test_relocalization.py's bar). About 90 s alone on two threads."""

import jax
import numpy as np
import pytest
import torch
import yaml

from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
from ceres_mono_orb_slam2_tpu.models.tracking import State as JaxState
from ceres_mono_orb_slam2_tpu.ops import bow as jbow
from ceres_mono_orb_slam2_tpu.ops.orb import ORBExtractor as JaxExtractor
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.utils import convert
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

torch.set_num_threads(2)
CENTRE_TOL = 0.02
INLIER_REL = 0.10
LOC_FRAMES = (5, 6, 7, 8)  # relocalize on frame 5's view, then track 6-8 in the mode
RESUME_FRAMES = range(9, 15)


class JaxTrackerNoise:
    """The JAX tracker's uniform draws: one split of the PRNGKey(0) chain per
    use, and for relocalization one more split into the fixed 8 candidate
    keys, the port taking the first C."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        if len(shape) == 3:
            keys = jax.random.split(k, 8)
            return torch.from_numpy(np.stack([np.array(jax.random.uniform(keys[c], tuple(shape[1:])))
                                              for c in range(shape[0])]))
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape))))


def centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _config():
    return SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=1500),
        shapes=StaticShapes(max_local_points=4096, max_local_keyframes=12,
                            max_ba_points=2048, max_ba_obs=8192))


def _localize(slam, seq, lost):
    """Relocalize on frame 5's view in localization mode, track 6-8, leave
    the mode and resume over 9-14. Returns per-frame (state, inliers, Tcw),
    keyframe counts before and after the mode, and the tracked points and
    keypoints of frame 8."""
    slam.activate_localization_mode()
    if lost is not None:
        slam.tracker.state = lost
    out = []
    n_kfs = slam.map.n_keyframes()
    for k in LOC_FRAMES:
        T = slam.track_monocular(seq.images[k], 99.0 + k)
        out.append((slam.get_tracking_state(), slam.n_tracked_points(), T))
    getters = ([None if mp is None else mp.id for mp in slam.get_tracked_map_points()],
               slam.get_tracked_keypoints_un(), np.asarray(slam.tracker.current.kp_valid))
    n_kfs_after = slam.map.n_keyframes()
    slam.deactivate_localization_mode()
    for k in RESUME_FRAMES:
        T = slam.track_monocular(seq.images[k], 99.0 + k)
        out.append((slam.get_tracking_state(), slam.n_tracked_points(), T))
    return out, n_kfs, n_kfs_after, getters


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    seq = make_sequence(n_frames=40, seed=11, motion="strafe", step=0.12)  # cached; frames 0-14 used
    cfg = _config()
    feats = JaxExtractor(cfg.orb).extract(seq.images[0])
    jvoc = jbow.train_vocabulary(np.asarray(feats.desc)[0], k=8, levels=3, seed=0)
    tvoc = convert.vocabulary_from_reference(jvoc)
    tcfg = convert.config_from_reference(cfg)

    jslam = JaxSLAM(cfg, vocabulary=jvoc)
    tslam = MonoSLAM(tcfg, vocabulary=tvoc, device="cpu")
    tslam.tracker.uniform_noise = JaxTrackerNoise()
    for slam in (jslam, tslam):
        for k in range(11):
            slam.track_monocular(seq.images[k], seq.timestamps[k])
    jpath, tpath = str(d / "jax_map.npz"), str(d / "port_map.npz")
    jslam.save_map(jpath)
    tslam.save_map(tpath)

    loaded = {}
    for name, path in (("jax_file", jpath), ("port_file", tpath)):
        a = JaxSLAM(cfg, vocabulary=jvoc)
        a.load_map(path)
        b = MonoSLAM(tcfg, vocabulary=tvoc, device="cpu")
        b.load_map(path)
        loaded[name] = (a, b)

    # localization over the JAX file's map, in both packages
    jsys = JaxSLAM(cfg, vocabulary=jvoc)
    jsys.load_map(jpath)
    jloc = _localize(jsys, seq, JaxState.LOST)
    tsys = MonoSLAM(tcfg, vocabulary=tvoc, device="cpu")
    tsys.load_map(jpath)
    tsys.tracker.uniform_noise = JaxTrackerNoise()
    tloc = _localize(tsys, seq, None)  # the port's load_map left it LOST
    return dict(seq=seq, d=d, cfg=tcfg, tvoc=tvoc, jslam=jslam, tslam=tslam, jpath=jpath,
                tpath=tpath, loaded=loaded, jloc=jloc, tloc=tloc, jsys=jsys, tsys=tsys)


def _assert_same_map(a, b):
    """A JAX map and a port map hold the same keyframes and points."""
    ma, mb = a.map, b.map
    assert ma.n_keyframes() == mb.n_keyframes() > 0
    assert ma.n_map_points() == mb.n_map_points() > 0
    assert sorted(ma.keyframes) == sorted(mb.keyframes)
    assert sorted(ma.map_points) == sorted(mb.map_points)
    assert ma.next_kf_id == mb.next_kf_id and ma.keyframe_origins == mb.keyframe_origins
    for kid, ka in ma.keyframes.items():
        kb = mb.keyframes[kid]
        assert ka.frame_id == kb.frame_id and ka.timestamp == kb.timestamp
        np.testing.assert_array_equal(ka.Rcw, kb.Rcw)
        np.testing.assert_array_equal(ka.tcw, kb.tcw)
        np.testing.assert_array_equal(ka.mp_ids, kb.mp_ids)
        for name in ("kp_xy", "kp_und", "kp_octave", "kp_angle", "kp_response", "desc", "kp_valid"):
            np.testing.assert_array_equal(np.asarray(getattr(ka, name)), getattr(kb, name), err_msg=name)
        assert ka.covisible == kb.covisible and ka.parent == kb.parent and ka.children == kb.children
    for mid, pa in ma.map_points.items():
        pb = mb.map_points[mid]
        np.testing.assert_array_equal(pa.pos, pb.pos)
        np.testing.assert_array_equal(pa.descriptor, pb.descriptor)
        assert pa.observations == pb.observations and pa.ref_kf_id == pb.ref_kf_id
        np.testing.assert_allclose(pa.normal, pb.normal, atol=1e-6)
        assert pa.min_dist == pytest.approx(pb.min_dist, rel=1e-6)
    assert a.keyframe_db.inverted == b.keyframe_db.inverted


def test_maps_load_into_either_package(runs):
    for name in ("jax_file", "port_file"):
        _assert_same_map(*runs["loaded"][name])
    # the loaded maps are the saved ones, with point ids renumbered in file order
    for slam, (_, b) in ((runs["jslam"], runs["loaded"]["jax_file"]), (runs["tslam"], runs["loaded"]["port_file"])):
        assert b.map.n_keyframes() == slam.map.n_keyframes()
        assert b.map.n_map_points() == slam.map.n_map_points()
        kf = sorted(slam.map.all_keyframes(), key=lambda k: k.id)[-1]
        np.testing.assert_array_equal(b.map.keyframes[kf.id].desc, kf.desc)


def test_saved_files_have_the_same_layout(runs):
    ja, ta = np.load(runs["jpath"]), np.load(runs["tpath"])
    assert sorted(ja.files) == sorted(ta.files)
    for key in ja.files:
        assert ja[key].dtype == ta[key].dtype, key
        assert ja[key].shape[1:] == ta[key].shape[1:], key
    # the port's run fed the JAX draws maps what the JAX run maps
    assert abs(len(ja["kf_ids"]) - len(ta["kf_ids"])) <= 1
    assert abs(len(ja["mp_ids"]) - len(ta["mp_ids"])) <= 0.05 * len(ja["mp_ids"])


def test_load_map_leaves_the_port_lost(runs):
    b = MonoSLAM(runs["cfg"], vocabulary=runs["tvoc"], device="cpu")
    epoch = b.map.correction_epoch
    b.load_map(runs["jpath"])
    assert b.get_tracking_state() == "LOST" and b.tracker.velocity is None
    assert b.map.correction_epoch == epoch + 1
    assert all(kf.dev is None for kf in b.map.keyframes.values())  # uploads on first use


def test_localization_matches_jax(runs):
    (jout, jn, jn_after, _), (tout, tn, tn_after, _) = runs["jloc"], runs["tloc"]
    assert jn == tn and jn_after == jn and tn_after == tn, "localization mode must not map"
    for k, ((js, ji, jT), (ts, ti, tT)) in zip(list(LOC_FRAMES) + list(RESUME_FRAMES), zip(jout, tout)):
        assert js == ts == "OK", (k, js, ts)
        assert jT is not None and tT is not None, k
        assert np.linalg.norm(centre(tT) - centre(jT)) < CENTRE_TOL, k
        assert abs(ji - ti) <= INLIER_REL * max(ji, ti), (k, ji, ti)
    jsys, tsys = runs["jsys"], runs["tsys"]
    stats = tsys.tracker.frame_stats
    assert stats[0]["method"] == "reloc" and stats[0]["ok"]
    assert [s["method"] for s in stats[1:4]] == [s["method"] for s in jsys.tracker.frame_stats[1:4]]
    assert tsys.map.n_keyframes() > tn, "the map did not grow on resume"


def test_relocalized_and_resumed_poses_are_accurate(runs):
    seq = runs["seq"]
    ts, pos = runs["jslam"].get_frame_trajectory()  # the saved map's own run
    c5 = pos[int(np.argmin(np.abs(ts - seq.timestamps[5])))]
    _, _, tT = runs["tloc"][0][0]
    assert np.linalg.norm(centre(tT) - c5) < CENTRE_TOL
    est = np.stack([centre(T) for _, _, T in runs["tloc"][0][len(LOC_FRAMES):]])
    gt = seq.gt_centers()[list(RESUME_FRAMES)]
    traj = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert ate_rmse(est, gt) < 0.02 * traj


def test_tracked_getters_match_jax(runs):
    (_, _, _, (jids, jkp, jvalid)), (_, _, _, (tids, tkp, tvalid)) = runs["jloc"], runs["tloc"]
    assert len(tids) == len(tkp) == len(tvalid) and len(jids) == len(jkp)
    # slot for slot: padded slots hold NaN, every bound slot a valid keypoint
    assert np.isnan(tkp[~tvalid]).all() and np.isfinite(tkp[tvalid]).all()
    assert all(tvalid[i] for i, mid in enumerate(tids) if mid is not None)
    tslot = {mid: i for i, mid in enumerate(tids) if mid is not None}
    jslot = {mid: i for i, mid in enumerate(jids) if mid is not None}
    both = sorted(set(tslot) & set(jslot))
    assert len(tslot) >= 50 and len(both) >= 0.8 * len(jslot), (len(tslot), len(jslot), len(both))
    # a point bound in both packages sits on the same keypoint
    d = np.linalg.norm(tkp[[tslot[m] for m in both]] - jkp[[jslot[m] for m in both]], axis=1)
    assert np.median(d) < 0.01 and (d < 1.0).mean() >= 0.95, np.percentile(d, [50, 95, 100])


def test_frame_trajectory_file_matches_jax(runs):
    d = runs["d"]
    rows = {}
    for name, slam in (("jax", runs["jsys"]), ("port", runs["tsys"])):
        p = d / f"{name}_frames.txt"
        slam.save_frame_trajectory_tum(str(p))
        rows[name] = np.array([line.split() for line in p.read_text().strip().split("\n")], np.float64)
    j, t = rows["jax"], rows["port"]
    assert t.shape == j.shape == (len(LOC_FRAMES) + len(RESUME_FRAMES), 8)
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    assert np.abs(t[:, 1:4] - j[:, 1:4]).max() < CENTRE_TOL
    np.testing.assert_allclose(np.linalg.norm(t[:, 4:], axis=1), 1.0, atol=1e-5)


def test_save_trajectory_and_map(runs, tmp_path):
    """Port of tests/test_slam_e2e.py::test_save_trajectory."""
    slam = runs["tslam"]
    p = tmp_path / "kf_traj.txt"
    slam.save_keyframe_trajectory_tum(str(p))
    lines = p.read_text().strip().split("\n")
    assert len(lines) == slam.map.n_keyframes()
    row = np.array(lines[0].split(), np.float64)
    assert len(row) == 8 and abs(np.linalg.norm(row[4:]) - 1) < 1e-5
    p2 = tmp_path / "frame_traj.txt"
    slam.save_frame_trajectory_tum(str(p2))
    # every frame logged since initialisation (the 11-frame run logs 8)
    assert len(p2.read_text().strip().split("\n")) == len(slam.tracker.trajectory) >= 8
    p3 = tmp_path / "map.npz"
    slam.save_map(str(p3))
    assert np.load(p3)["mp_pos"].shape[0] == slam.map.n_map_points()


def test_save_map_yaml_reference_format(runs, tmp_path):
    """Port of tests/test_slam_e2e.py::test_save_map_yaml_reference_format;
    the port's YAML text equals the JAX package's for the same loaded map."""
    slam = runs["tslam"]
    p = tmp_path / "map.yaml"
    slam.save_map_yaml(str(p))
    text = p.read_text()
    assert text.startswith("%YAML:1.0\n---\n")

    class _L(yaml.SafeLoader):
        pass

    def _mat(loader, node):
        d = loader.construct_mapping(node, deep=True)
        return np.array(d["data"]).reshape(d["rows"], d["cols"])

    _L.add_constructor("tag:yaml.org,2002:opencv-matrix", _mat)
    doc = yaml.load(text.split("---\n", 1)[1], Loader=_L)
    assert len(doc["MapPoints"]) == slam.map.n_map_points()
    assert len(doc["KeyFrames"]) == slam.map.n_keyframes()
    mp0 = doc["MapPoints"][0]
    assert mp0["pos"].shape == (3, 1) and mp0["descriptor"].shape == (1, 32)
    kf0 = doc["KeyFrames"][0]
    kf = sorted(slam.map.all_keyframes(), key=lambda k: k.id)[0]
    np.testing.assert_allclose(kf0["R"], kf.Rcw.T, atol=1e-6)
    np.testing.assert_allclose(kf0["t"][:, 0], -kf.Rcw.T @ kf.tcw, atol=1e-5)
    assert set(kf0["map_point_indices"][0].astype(int)) <= {mp.id for mp in slam.map.all_map_points()}
    ja, tb = runs["loaded"]["port_file"]
    pj, pt = tmp_path / "j.yaml", tmp_path / "t.yaml"
    ja.save_map_yaml(str(pj))
    tb.save_map_yaml(str(pt))
    assert pj.read_text() == pt.read_text()


def test_pipelined_localization_chains_no_frame(runs):
    seq = runs["seq"]
    slam = MonoSLAM(runs["cfg"], vocabulary=runs["tvoc"], device="cpu", pipelined=True)
    slam.tracker.uniform_noise = JaxTrackerNoise()
    slam.load_map(runs["jpath"])
    slam.activate_localization_mode()
    n_kfs = slam.map.n_keyframes()
    for k in LOC_FRAMES:
        slam.track_monocular(seq.images[k], 99.0 + k)
    slam.shutdown()
    assert slam.get_tracking_state() == "OK"
    assert slam.tracker.n_chained_frames == 0 and slam.tracker.n_fused_frames == 0
    assert slam.map.n_keyframes() == n_kfs


def test_load_map_keeps_gapped_keyframe_ids(runs, tmp_path):
    """A saved map whose keyframe ids have a gap (culling leaves them) loads
    with every keyframe under its own id. The JAX loader re-keys keyframes
    created under sequential ids and overwrites one at the gap, then fails
    (a reference fault; the JAX package stays as it is)."""
    data = dict(np.load(runs["jpath"]))
    keep = np.arange(len(data["kf_ids"])) != 1
    for key in [k for k in data if k.startswith("kf_")]:
        data[key] = data[key][keep]
    path = str(tmp_path / "gapped.npz")
    np.savez_compressed(path, **data)
    b = MonoSLAM(runs["cfg"], vocabulary=runs["tvoc"], device="cpu")
    b.load_map(path)
    assert sorted(b.map.keyframes) == sorted(int(k) for k in data["kf_ids"])
    assert b.map.next_kf_id == int(data["kf_ids"].max()) + 1
    for kid, kf in b.map.keyframes.items():
        i = int(np.nonzero(data["kf_ids"] == kid)[0][0])
        np.testing.assert_array_equal(kf.desc, data["kf_desc"][i])
    with pytest.raises(KeyError):
        JaxSLAM(_config()).load_map(path)
