"""The captured programs (`utils/graphs.py`) against the direct calls.

On the card `Tracking`, `MonoSLAM`, `MultiStreamSLAM` and
`make_multistream_step` replay their per-frame device work as CUDA graphs
(`graphs=True`, the default). On the CPU the same code runs the staged path:
every argument is copied into the program's static buffers (the local-map
block gathered into them), the function runs on those buffers and its
outputs are handed out as clones. Here the staged path runs against the
direct one (`graphs=False`) on the CPU and must give the same bits:

- a 20-frame serial spiral (240x320 rendered frames, 1000 features): every
  fused frame's outputs, features and control buffer, every pose;
- a pipelined run that chains at full rate (the geometric front end, which
  extracts outside the program): every chained frame's outputs, the poses
  returned one frame late and the drained trajectory;
- a relocalization through the captured pose solve, then the fused frame
  that searches the local map at the widened radius (th_local 5.0);
- `MultiStreamSLAM` at S=3 over the spiral (the streams start 0, 2 and 4
  frames in): every batched frame's outputs and every pose.

Then `FusedStep` with a tensor `th_local` of 1.0 and 5.0 against the JAX
package's `build_fused_step`, at tests/test_torch_fused_step.py's
tolerances, and the helper's own rules: a Python number is refused, a new
shape makes a new program. About 60 s on one worker (the spiral's render,
12 s, is cached on disk by the JAX package's renderer)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models.fused_track import build_fused_step
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig as JCameraConfig
from ceres_mono_orb_slam2_tpu.utils.config import ORBConfig as JORBConfig
from ceres_mono_orb_slam2_tpu.utils.config import SlamConfig as JSlamConfig
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.models import fused_track
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.models.tracking import State
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.parallel.multisystem import MultiStreamSLAM
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.convert import config_from_reference
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from test_torch_multistream import BOUNDS, _fused_inputs

torch.set_num_threads(2)
H, W, F = 240, 320, 250.0  # the spiral
GH, GW = 480, 640  # the geometric front end's frames
SPIRAL_FRAMES, MS_FRAMES, MS_OFFSETS = 20, 6, (0, 2, 4)

_THREADS_BEFORE = set(threading.enumerate())


@pytest.fixture(autouse=True)
def no_worker_thread_left():
    yield
    left = [t.name for t in threading.enumerate()
            if t.name in ("mapper", "gba") and t.is_alive() and t not in _THREADS_BEFORE]
    assert not left, f"worker threads left alive: {left}"


def _spiral_config():
    return SlamConfig(camera=CameraConfig(fx=F, fy=F, cx=W / 2, cy=H / 2, fps=30.0),
                      orb=ORBConfig(n_features=1000),
                      shapes=StaticShapes(max_local_points=1024, max_local_keyframes=12,
                                          max_ba_points=1024, max_ba_obs=4096))


def _geo_config():
    return SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
                      orb=ORBConfig(n_features=600),
                      shapes=StaticShapes(max_local_points=1024, max_local_keyframes=12,
                                          max_ba_points=1024, max_ba_obs=4096))


@pytest.fixture(scope="module")
def spiral():
    return make_sequence(n_frames=SPIRAL_FRAMES, h=H, w=W, fx=F, fy=F, motion="spiral", step=0.06,
                         seed=11)


def _record(tracker) -> list:
    """Every device phase's (out, feats, ctl) of this tracker, in order."""
    seen = []
    dispatch, chained = tracker._fused_dispatch, tracker._dispatch_chained

    def fused(args):
        out, feats, ctl, lblock = dispatch(args)
        seen.append(("fused", float(args[9]), out, feats, ctl))
        return out, feats, ctl, lblock

    def chain(image, p):
        out, feats, copy = chained(image, p)
        seen.append(("chained", 1.0, out, feats, copy[0]))
        return out, feats, copy

    tracker._fused_dispatch, tracker._dispatch_chained = fused, chain
    return seen


def _assert_same_bits(a, b, where=""):
    """Two recorded device-phase lists, or two pose lists, equal to the bit."""
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, tuple) and x and isinstance(x[0], str):  # a recorded device phase
            assert x[:2] == y[:2], (where, i)
            for tree_x, tree_y in zip(x[2:], y[2:]):
                for name, tx, ty in zip(getattr(tree_x, "_fields", ("ctl",)),
                                        tree_x if isinstance(tree_x, tuple) else (tree_x,),
                                        tree_y if isinstance(tree_y, tuple) else (tree_y,)):
                    assert tx.dtype == ty.dtype and torch.equal(tx, ty), (where, i, name)
        else:  # a pose, or None
            assert (x is None) == (y is None), (where, i)
            if x is not None:
                assert np.array_equal(x, y), (where, i)


def _world():
    return GeoWorld(np.random.default_rng(0), 2500, extent=10.0)


def _geo(slam, n_frames, world):
    """The geometric front end over a strafe of n_frames in `world`."""
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe", 0.12)
    slam.tracker.extractor = GeoExtractor(world, slam.config.camera.K, Rcw, tcw, 600, GH, GW,
                                          px_noise=0.3, bit_noise=2, seed=5, device="cpu")


def test_serial_spiral_staged_equals_direct(spiral):
    """The serial spiral: the frontend program (extraction with both
    kernels' plain versions, the fused step, pack_control) staged against
    the direct calls, every fused frame to the bit."""
    runs = {}
    for g in (True, False):
        slam = MonoSLAM(_spiral_config(), device="cpu", graphs=g)
        seen = _record(slam.tracker)
        poses = [slam.track_monocular(spiral.images[k], spiral.timestamps[k])
                 for k in range(SPIRAL_FRAMES)]
        slam.shutdown()
        runs[g] = (slam, seen, poses)
    (staged, seen_s, poses_s), (direct, seen_d, poses_d) = runs[True], runs[False]
    _assert_same_bits(seen_s, seen_d, "device phases")
    _assert_same_bits(poses_s, poses_d, "poses")
    assert staged.tracker.n_fused_frames == direct.tracker.n_fused_frames >= 12
    programs = staged.tracker.programs()
    frontend = [p for p in programs if p["name"] == "frontend"]
    assert len(frontend) == 1 and frontend[0]["calls"] == staged.tracker.n_fused_frames
    assert frontend[0]["captures"] == 0  # the CPU stages without capture
    assert direct.tracker.programs() == []


def test_pipelined_chains_staged_equals_direct():
    """Pipelined at full rate, unthreaded: the chained frames select the
    on-device prediction and the previous frame's outputs inside the same
    program; the pipeline start's local block outlives the serial frames'
    gathers into the program's buffers."""
    n_frames = 12
    runs = {}
    for g in (True, False):
        slam = MonoSLAM(_geo_config(), device="cpu", pipelined=True, graphs=g)
        _geo(slam, n_frames, _world())
        seen = _record(slam.tracker)
        poses = [slam.track_monocular(frame_image(k, GH, GW), k / 30.0) for k in range(n_frames)]
        slam.shutdown()
        runs[g] = (slam, seen, poses, slam.get_frame_trajectory())
    (staged, seen_s, poses_s, traj_s), (direct, seen_d, poses_d, traj_d) = runs[True], runs[False]
    assert staged.tracker.n_chained_frames == direct.tracker.n_chained_frames >= 4
    assert sum(kind == "chained" for kind, *_ in seen_s) == staged.tracker.n_chained_frames
    _assert_same_bits(seen_s, seen_d, "device phases")
    _assert_same_bits(poses_s, poses_d, "poses")
    assert np.array_equal(traj_s[0], traj_d[0]) and np.array_equal(traj_s[1], traj_d[1])


def test_relocalization_then_wide_radius_frame():
    """A blinded tracker relocalizes through the captured pose solve, and
    the next frame fuses with th_local 5.0 (the widened local search right
    after a relocalization): staged equal to direct to the bit."""
    n_map = 8
    runs = {}
    for g in (True, False):
        world = _world()
        voc = bow.train_vocabulary(world.desc[:1500], k=8, levels=3, seed=0, device="cpu")
        slam = MonoSLAM(_geo_config(), vocabulary=voc, device="cpu", graphs=g)
        _geo(slam, n_map + 2, world)
        seen = _record(slam.tracker)
        poses = [slam.track_monocular(frame_image(k, GH, GW), k / 30.0) for k in range(n_map)]
        tr = slam.tracker
        tr.state, tr.velocity = State.LOST, None  # kidnap: blind the tracker
        poses += [slam.track_monocular(frame_image(k, GH, GW), k / 30.0) for k in (n_map, n_map + 1)]
        slam.shutdown()
        runs[g] = (slam, seen, poses)
    (staged, seen_s, poses_s), (direct, seen_d, poses_d) = runs[True], runs[False]
    for slam in (staged, direct):
        stats = slam.tracker.frame_stats
        assert stats[-2]["method"] == "reloc" and stats[-2]["ok"]
        assert stats[-1]["method"] == "fused" and stats[-1]["ok"]
    assert seen_s[-1][:2] == ("fused", 5.0)
    _assert_same_bits(seen_s, seen_d, "device phases")
    _assert_same_bits(poses_s, poses_d, "poses")
    solves = [p for p in staged.tracker.programs() if p["name"] == "pose_optimization"]
    assert solves and sum(p["calls"] for p in solves) >= 1


def test_multistream_s3_staged_equals_direct(spiral):
    """MultiStreamSLAM at S=3: the batched program (one extraction, the
    stream-axis fused step, the packed control buffers) with the per-stream
    pool gathers and the last-frame stacks written into its buffers."""
    runs = {}
    for g in (True, False):
        ms = MultiStreamSLAM(_spiral_config(), n_streams=len(MS_OFFSETS), device="cpu", graphs=g)
        seen, frontend = [], ms._batched_frontend

        def record(args, frontend=frontend, seen=seen):
            out, feats, ctl, t = frontend(args)
            seen.append(("batched", len(args), out, feats, torch.from_numpy(ctl)))
            return out, feats, ctl, t

        ms._batched_frontend = record
        poses = []
        for k in range(MS_FRAMES):
            poses += ms.track_batch([spiral.images[k + o] for o in MS_OFFSETS],
                                    [spiral.timestamps[k + o] for o in MS_OFFSETS])
        ms.shutdown()
        runs[g] = (ms, seen, poses)
    (staged, seen_s, poses_s), (direct, seen_d, poses_d) = runs[True], runs[False]
    assert staged.n_batched_frames == direct.n_batched_frames >= 3
    _assert_same_bits(seen_s, seen_d, "batched device phases")
    _assert_same_bits(poses_s, poses_d, "poses")
    report = staged.programs()
    assert {tuple(p["shapes"][0]) for p in report} <= {(s, H, W) for s in (2, 3)}
    assert sum(p["calls"] for p in report) == staged.n_batched_frames


@pytest.mark.parametrize("th", [1.0, 5.0])
def test_fused_step_tensor_radius_matches_jax(th):
    """`FusedStep` with th_local a 0-d float32 tensor against the JAX
    `build_fused_step` with the same traced radius, on one stream's
    synthetic inputs: every index, mask and count equal, R and t within
    1e-4 (tests/test_torch_fused_step.py's bars)."""
    jcfg = JSlamConfig(camera=JCameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0),
                       orb=JORBConfig(n_features=300))
    ins = _fused_inputs(np.random.default_rng(0))
    args = (*ins["cur"], *ins["last"], *ins["pred"], *ins["loc"], BOUNDS)
    out_t = fused_track.FusedStep(config_from_reference(jcfg), device="cpu")(*args, torch.tensor(th))
    out_j = build_fused_step(jcfg)(*(jnp.asarray(a.numpy()) for a in args), jnp.float32(th))
    for name in out_t._fields:
        got, want = getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name))
        if name in ("R", "t"):
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        elif name in ("und", "pos_kp"):
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(out_t.n2_inliers) > 100
    with pytest.raises(TypeError):
        fused_track.FusedStep(config_from_reference(jcfg), device="cpu")(*args, th)


def test_helper_refuses_numbers_and_keys_by_shape():
    calls = []

    def fn(x, pair):
        calls.append(x.shape)
        return x * pair[0] + pair[1], x  # the second output is an input

    f = graphs.CapturedFunction(fn, "cpu", name="fn")
    with pytest.raises(TypeError, match="not a tensor"):
        f(torch.ones(3), (2.0, torch.zeros(3)))
    x = torch.arange(3.0)
    y, same = f(x, (torch.tensor(2.0), torch.ones(3)))
    assert torch.equal(y, torch.tensor([1.0, 3.0, 5.0])) and torch.equal(same, x)
    # outputs are clones: neither the caller's tensor nor the static buffer
    assert same.data_ptr() != x.data_ptr()
    assert same.data_ptr() != f.last_inputs[0].data_ptr()
    f(torch.ones(3), (torch.tensor(1.0), torch.ones(3)))
    assert len(f.programs) == 1
    f(torch.ones(4), (torch.tensor(1.0), torch.ones(4)))
    assert len(f.programs) == 2 and calls == [(3,), (3,), (4,)]
    assert [p["calls"] for p in f.report()] == [2, 1]
    # a Fill writes its buffer itself: the gather never hands its source over
    src = torch.arange(12.0).reshape(6, 2)
    idx = torch.tensor([5, 0, 3])
    g = graphs.CapturedFunction(lambda rows: rows + 0, "cpu")
    assert torch.equal(g(graphs.gathered(src, idx)), src[idx])
    assert torch.equal(g(src[[1, 2, 4]]), src[[1, 2, 4]]) and len(g.programs) == 1
