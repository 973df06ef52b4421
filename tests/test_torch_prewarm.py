"""`MonoSLAM.prewarm(h, w)` (`models/prewarm.py`) on the CPU.

The port of the JAX package's `MonoSLAM.prewarm`: before frame 0 it calls
each tracker program whose key the configuration and (h, w) fix, and the
loop closer's Sim(3) refinement, once on dummy inputs. On the CPU the
programs stage without capture, so each function runs once. Here:

- a prewarmed system and an unprewarmed one, fed the same 8 frames of a
  rendered strafe (240x320, 1000 features; it initialises at frame 3 and
  fuses after), give the same poses, keyframe poses and map points to the
  bit;
- prewarm leaves the tracker's and the loop closer's random generators,
  the frame counters, the empty map, the tracker's state and the kernels'
  launch counts as they were, with graphs and without (kernel wrappers
  that count stand in for the card's launches);
- the tracker's and the loop closer's `captured()` name the programs it
  called; it returns its phases' times and `total_s`;
- it raises after frame 0;
- a system with the geometric front end (`GeoExtractor`) and a vocabulary
  prewarms without a call of its extractor, which draws its own noise, and
  its live frames then reuse the programs prewarm made.

About 22 s on one worker (pytest, 2 threads)."""

import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu_torch.models import frame as frame_mod
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence

torch.set_num_threads(2)
H, W, F, FRAMES = 240, 320, 250.0, 8
GH, GW, GEO_FRAMES = 480, 640, 6  # the geometric front end's frames
TRACKER_PROGRAMS = {"frontend", "extract", "pose_optimization", "ransac_p3p", "ransac_select",
                    "ransac_projection", "ransac_refit", "init_match"}
PHASES = ["pool", "extract", "frontend", "pose_opt", "reloc", "init_match"]


def _config(n_features: int = 1000):
    return SlamConfig(camera=CameraConfig(fx=F, fy=F, cx=W / 2, cy=H / 2, fps=30.0),
                      orb=ORBConfig(n_features=n_features),
                      shapes=StaticShapes(max_local_points=1024, max_local_keyframes=12,
                                          max_ba_points=1024, max_ba_obs=4096))


def _trace(slam) -> dict:
    """What prewarm must leave as it was."""
    tr = slam.tracker
    return {"tracker generator": tr.generator.get_state().clone(),
            "loop closer generator": (slam.loop_closer.generator.get_state().clone()
                                      if slam.loop_closer else None),
            # a count's repr shows its next value without taking it
            "frame counter": repr(frame_mod._frame_counter), "frame sequence": repr(tr._frame_seq),
            "keyframes": slam.map.n_keyframes(), "map points": slam.map.n_map_points(),
            "state": tr.state, "current": tr.current, "launch counts": dict(kernels.launch_counts)}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a)


def _named(captured) -> set:
    return {f.name for f in captured if f.programs}


@pytest.fixture(scope="module")
def strafe():
    return make_rendered_sequence(FRAMES, H, W, F, F, motion="strafe", step=0.06, seed=0)


@pytest.fixture(scope="module")
def warm_and_cold(strafe):
    """(prewarmed system, its trace before and after prewarm, prewarm's
    result and the programs it named, unprewarmed system, both systems'
    poses)."""
    warm, cold = MonoSLAM(_config(), device="cpu"), MonoSLAM(_config(), device="cpu")
    before = _trace(warm)
    phases = warm.prewarm(H, W)
    after = _trace(warm)
    phases = (phases, _named(warm.tracker.captured()))
    poses = [[], []]
    for i in range(FRAMES):
        for j, slam in enumerate((warm, cold)):
            poses[j].append(slam.track_monocular(strafe.images[i], float(strafe.timestamps[i])))
    return warm, before, after, phases, cold, poses


def test_prewarmed_system_equals_the_unprewarmed_one_to_the_bit(warm_and_cold):
    warm, _, _, _, cold, poses = warm_and_cold
    assert [T is None for T in poses[0]] == [T is None for T in poses[1]]
    assert all(T is None or np.array_equal(T, U) for T, U in zip(*poses))
    assert warm.tracker.n_fused_frames == cold.tracker.n_fused_frames >= 2
    assert sorted(warm.map.keyframes) == sorted(cold.map.keyframes) and warm.map.n_keyframes() >= 3
    for k, kf in warm.map.keyframes.items():
        assert np.array_equal(kf.Rcw, cold.map.keyframes[k].Rcw)
        assert np.array_equal(kf.tcw, cold.map.keyframes[k].tcw)
    assert sorted(warm.map.map_points) == sorted(cold.map.map_points)
    for i, mp in warm.map.map_points.items():
        assert np.array_equal(mp.pos, cold.map.map_points[i].pos)
    assert [st["method"] for st in warm.tracker.frame_stats] == [st["method"] for st in cold.tracker.frame_stats]


def test_prewarm_leaves_no_trace(warm_and_cold):
    _, before, after, *_ = warm_and_cold
    assert _same(before, after), {k for k in before if not _same({k: before[k]}, {k: after[k]})}
    assert after["state"].name == "NO_IMAGES_YET" and after["keyframes"] == after["map points"] == 0


@pytest.mark.parametrize("graphs", [True, False])
def test_prewarm_puts_the_launch_counts_back(monkeypatch, graphs):
    """On the card each kernel wrapper adds one to its count at a launch;
    on the CPU it runs its plain version and counts nothing. Wrappers that
    count stand in here: prewarm extracts twice (the extraction, the
    frontend), with graphs and without, and leaves the counts, and the
    rest of the trace, as they were."""
    calls = {"fast_nms": 0, "gather_patches": 0}
    for name, attr in (("fast_nms", "fast_nms_pyramid"), ("gather_patches", "gather_pyramid_patches")):
        def counted(*a, _fn=getattr(kernels, attr), _name=name, **kw):
            kernels.launch_counts[_name] += 1
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernels, attr, counted)
    slam = MonoSLAM(_config(), device="cpu", graphs=graphs)
    before = _trace(slam)
    phases = slam.prewarm(H, W)
    assert _same(before, _trace(slam)) and calls == {"fast_nms": 2, "gather_patches": 2}
    assert list(phases) == PHASES + ["total_s"]
    assert _named(slam.tracker.captured()) == (TRACKER_PROGRAMS if graphs else set())


def test_captured_names_the_prewarmed_programs(warm_and_cold):
    warm, _, _, (_, named), *_ = warm_and_cold
    assert named == TRACKER_PROGRAMS
    # the live frames that followed it reused the programs' keys
    assert all(len(f.programs) == 1 for f in warm.tracker.captured() if f.name in TRACKER_PROGRAMS)


def test_prewarm_returns_its_phase_times(warm_and_cold):
    _, _, _, (phases, _), *_ = warm_and_cold
    assert list(phases) == PHASES + ["total_s"]
    times = list(phases.values())
    assert all(isinstance(t, float) for t in times) and times == sorted(times) and times[0] >= 0.0


def test_prewarm_raises_after_frame_0(strafe):
    slam = MonoSLAM(_config(), device="cpu")
    slam.track_monocular(strafe.images[0], float(strafe.timestamps[0]))
    with pytest.raises(RuntimeError, match="before its first frame"):
        slam.prewarm(H, W)


def test_prewarm_never_calls_a_geo_extractor(monkeypatch):
    """The geometric front end with a vocabulary: prewarm captures the
    frontend from dummy features and the Sim(3) refinement at the
    extractor's N rows, without a call of the extractor."""
    n = 600
    Rcw, tcw = make_geo_trajectory(GEO_FRAMES, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    voc = bow.train_vocabulary(world.desc[:1000], k=8, levels=2, seed=0, device="cpu")
    cfg = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=GW / 2, cy=GH / 2, fps=30.0),
                     orb=ORBConfig(n_features=n), shapes=StaticShapes(max_local_points=1024))
    slam = MonoSLAM(cfg, vocabulary=voc, device="cpu")
    gx = slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, n, GH, GW, seed=5, device="cpu")
    rng = gx.rng.bit_generator.state

    def refuse(image):
        raise AssertionError("prewarm called the geometric extractor")

    monkeypatch.setattr(gx, "extract", refuse)
    before = _trace(slam)
    phases = slam.prewarm(GH, GW)
    assert _same(before, _trace(slam)) and gx.rng.bit_generator.state == rng
    assert list(phases) == ["pool", "frontend", "pose_opt", "reloc", "init_match", "sim3", "total_s"]
    assert _named(slam.tracker.captured()) == TRACKER_PROGRAMS - {"extract"}
    assert _named(slam.loop_closer.captured()) == {"sim3_lm"}
    (frontend,) = slam.tracker._frontend[1].programs.values()
    assert frontend.inputs[0].shape == (1, n, 2)  # the features' xy, not an image
    monkeypatch.undo()
    poses = [slam.track_monocular(frame_image(i, GH, GW), i / 30.0) for i in range(GEO_FRAMES)]
    assert poses[0] is None and poses[-1] is not None and slam.tracker.n_fused_frames >= 1
    # the live frames met the keys prewarm made: its features arrive as
    # numpy's x[None] (stride 0 in the batch dimension), prewarm's as zeros
    assert all(len(f.programs) == 1 for f in slam.tracker.captured() if f.name in TRACKER_PROGRAMS)
    assert len(slam.tracker._frontend[1].programs) == 1
