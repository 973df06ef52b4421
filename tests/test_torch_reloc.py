"""Port parity of kidnap relocalization (the first half of
tests/test_relocalization.py::test_kidnap_relocalization).

Both packages build a map over 11 strafe frames with the same vocabulary
(trained on frame 0's descriptors), are blinded (state LOST, no velocity)
and shown frame 5 again. The port's tracker is fed the JAX tracker's RANSAC
draws: one split of the PRNGKey(0) chain per use, and for relocalization one
further split per candidate of the fixed 8, the port taking the first C.
Stated bars: both recover, and the recovered camera centres lie within 0.02
of each other and of each package's own frame-5 centre."""

import numpy as np
import jax
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
from ceres_mono_orb_slam2_tpu.models.tracking import State as JaxState
from ceres_mono_orb_slam2_tpu.ops import bow as jbow
from ceres_mono_orb_slam2_tpu.ops.orb import ORBExtractor as JaxExtractor
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.models.tracking import State
from ceres_mono_orb_slam2_tpu_torch.utils import convert

torch.set_num_threads(2)


class JaxTrackerNoise:
    """The uniform draws of the JAX tracker: the PRNGKey(0) split chain of
    `Tracking._next_key`; a relocalization splits its key once more into the
    reference's fixed 8 candidate keys."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)
        self.n_reloc = 0

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        if len(shape) == 3:
            self.n_reloc += 1
            keys = jax.random.split(k, 8)
            return torch.from_numpy(np.stack([np.array(jax.random.uniform(keys[c], tuple(shape[1:])))
                                              for c in range(shape[0])]))
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape))))


def centre(T):
    return -T[:3, :3].T @ T[:3, 3]


@pytest.fixture(scope="module")
def kidnapped():
    seq = make_sequence(n_frames=11, seed=11, motion="strafe", step=0.12)
    cfg = SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=1500),
        shapes=StaticShapes(max_local_points=4096, max_local_keyframes=12,
                            max_ba_points=2048, max_ba_obs=8192),
    )
    feats = JaxExtractor(cfg.orb).extract(seq.images[0])
    jvoc = jbow.train_vocabulary(np.asarray(feats.desc)[0], k=8, levels=3, seed=0)
    jslam = JaxSLAM(cfg, vocabulary=jvoc)
    tslam = MonoSLAM(convert.config_from_reference(cfg),
                     vocabulary=convert.vocabulary_from_reference(jvoc), device="cpu")
    noise = tslam.tracker.uniform_noise = JaxTrackerNoise()
    out = []
    for slam, lost in ((jslam, JaxState.LOST), (tslam, State.LOST)):
        poses = [slam.track_monocular(seq.images[k], seq.timestamps[k]) for k in range(11)]
        state_before = slam.get_tracking_state()
        indexed = bool(slam.keyframe_db.inverted)
        slam.tracker.state = lost  # kidnap: blind the tracker, then show frame 5 again
        slam.tracker.velocity = None
        T = slam.track_monocular(seq.images[5], seq.timestamps[-1] + 1.0)
        out.append((slam, poses, state_before, indexed, T))
    return out, noise


def test_both_relocalize_to_the_same_place(kidnapped):
    ((jslam, jposes, jstate, jidx, jT), (tslam, tposes, tstate, tidx, tT)), noise = kidnapped
    assert jstate == tstate == "OK"
    assert jidx and tidx, "BoW index empty"
    assert jT is not None and tT is not None, "relocalization failed"
    assert jslam.get_tracking_state() == tslam.get_tracking_state() == "OK"
    assert noise.n_reloc == 1
    assert np.linalg.norm(centre(tT) - centre(tposes[5])) < 0.02
    assert np.linalg.norm(centre(jT) - centre(jposes[5])) < 0.02
    assert np.linalg.norm(centre(tT) - centre(jT)) < 0.02


def test_relocalization_bookkeeping(kidnapped):
    (_, (tslam, _, _, _, _)), _ = kidnapped
    trk = tslam.tracker
    assert trk.last_reloc_frame_id == trk.current.id == 11
    assert trk.frame_stats[-1]["method"] == "reloc" and trk.matches_inliers >= 50
    assert trk.n_resets == 0
    assert not tslam.map_changed()  # no loop was closed
    # a reset clears the database and the loop closer's queue
    tslam.loop_closer.queue.append(0)
    tslam.reset()
    assert not tslam.keyframe_db.inverted and not tslam.loop_closer.queue
    assert tslam.get_tracking_state() == "NOT_INITIALIZED" and trk.n_resets == 1


def test_without_a_relocalizer_a_lost_frame_stays_lost():
    from ceres_mono_orb_slam2_tpu_torch.utils.config import SlamConfig as TConfig

    slam = MonoSLAM(TConfig(), device="cpu")
    assert slam.keyframe_db is None and slam.loop_closer is None
    assert slam.tracker._relocalization() is False
