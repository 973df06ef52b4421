"""The port runs without JAX: it imports `torch` and never `jax`, not even
through the JAX package (whose __init__ imports jax), and renders its
viewers without matplotlib or PIL, which the card lacks too. Also holds the
port's device renderer to the JAX package's `render_frames_device`."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import ceres_mono_orb_slam2_tpu_torch as port

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent

_NO_JAX = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["ceres_mono_orb_slam2_tpu"] = None
sys.modules["matplotlib"] = None  # nor the card's absent renderers and image library
sys.modules["PIL"] = None
import importlib, pkgutil
import numpy as np
import ceres_mono_orb_slam2_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.ops.orb import ORBExtractor
from ceres_mono_orb_slam2_tpu_torch.utils.config import ORBConfig, SlamConfig
ex = ORBExtractor(ORBConfig(n_features=200), device="cpu")
f = ex.extract(np.random.default_rng(0).uniform(0, 255, (96, 128)).astype(np.float32))
assert f.xy.shape == (1, 200, 2)
slam = MonoSLAM(SlamConfig(), device="cpu")
assert slam.get_tracking_state() == "NO_IMAGES_YET"
# the relocalization and loop-closing slice: vocabulary, database, loop closer
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import GeoExtractor, GeoWorld, frame_image, make_geo_trajectory
voc = bow.synth_vocabulary(k=3, levels=2, seed=0)
slam = MonoSLAM(SlamConfig(), vocabulary=voc, device="cpu")
assert slam.keyframe_db is not None and slam.loop_closer is not None
assert slam.tracker.relocalizer is slam.keyframe_db
assert slam.local_mapper.loop_closer is slam.loop_closer
wid, path = slam.keyframe_db.transform(f.desc[0], f.valid[0])
assert wid.shape == (200,) and path.shape == (200, 5) and int(wid.max()) < voc.n_words
Rcw, tcw = make_geo_trajectory(3, "circle", 0.1)
gx = GeoExtractor(GeoWorld(np.random.default_rng(0), 300, shape="ring"), SlamConfig().camera.K,
                  Rcw, tcw, 100, 480, 640, device="cpu")
assert gx.extract(frame_image(1)).xy.shape == (1, 100, 2)
# the multi-stream slice: S systems behind one batched front end
from ceres_mono_orb_slam2_tpu_torch.parallel.multistream import make_multistream_step, synthetic_stream_state
from ceres_mono_orb_slam2_tpu_torch.parallel.multisystem import MultiStreamSLAM
ms = MultiStreamSLAM(SlamConfig(), n_streams=2, device="cpu")
assert len(ms.streams) == 2 and ms.streams[1].tracker.extractor is ms.extractor
assert ms.track_batch([np.zeros((96, 128), np.uint8)] * 2, [0.0, 0.0]) == [None, None]
assert ms.n_single_frames == 2 and ms.n_batched_frames == 0
cfg = SlamConfig(orb=ORBConfig(n_features=200))
images, state = synthetic_stream_state(cfg, 2, 64, h=96, w=128, device="cpu")
res = make_multistream_step(cfg, 96, 128, device="cpu")(images, state)
assert res.Rcw.shape == (2, 3, 3) and res.n_matches.shape == (2,)
# the threaded slice: the mapper thread, the global-BA thread, pipelined tracking
slam = MonoSLAM(SlamConfig(), vocabulary=voc, device="cpu", threaded=True, pipelined=True)
assert slam._worker.is_alive() and slam.loop_closer.threaded_gba and slam.tracker.pipelined
assert slam.track_monocular(np.zeros((96, 128), np.uint8), 0.0) is None
slam.shutdown()
assert not slam._worker.is_alive() and slam.tracker._pending is None
ms = MultiStreamSLAM(SlamConfig(), n_streams=2, threaded=True, device="cpu")
ms.shutdown()
# the CLI slice: dataset loaders, the native host I/O, the CLI end to end
import os, struct, tempfile, zlib
from ceres_mono_orb_slam2_tpu_torch import cli
from ceres_mono_orb_slam2_tpu_torch.utils import datasets, native
d = tempfile.mkdtemp()
img = np.random.default_rng(0).integers(0, 256, (96, 128), dtype=np.uint8)
chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))
os.makedirs(os.path.join(d, "rgb"))
with open(os.path.join(d, "rgb", "0.png"), "wb") as f:
    f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 128, 96, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.insert(img, 0, 0, axis=1).tobytes())) + chunk(b"IEND", b""))
with open(os.path.join(d, "rgb.txt"), "w") as f:
    f.write("0.000000 rgb/0.png\n")
ds = datasets.load_auto(d)
assert np.array_equal(ds[0][0], img.astype(np.float32))
assert np.array_equal(datasets.imread_gray_plain(ds.paths[0]), img.astype(np.float32))
assert native.available() or native.build_error()
with open(os.path.join(d, "cfg.yaml"), "w") as f:
    f.write("%YAML:1.0\nCamera.fx: 100.0\nCamera.fy: 100.0\nCamera.cx: 64.0\nCamera.cy: 48.0\n"
            "ORBextractor.nFeatures: 200\n")
assert cli.main(["--config", os.path.join(d, "cfg.yaml"), "--images", d, "--output-dir", os.path.join(d, "out"),
                 "--device", "cpu"]) == 0
assert sorted(os.listdir(os.path.join(d, "out"))) == ["FrameTrajectory.txt", "KeyFrameTrajectory.txt",
                                                      "map.npz", "map.yaml"]
# the viewer slice: snapshots and the live HTTP viewer, rendered without matplotlib
import io
from ceres_mono_orb_slam2_tpu_torch.utils import png
slam = MonoSLAM(SlamConfig(), device="cpu", use_viewer=True, live_viewer_port=0)
buf = io.BytesIO()
slam.viewer.snapshot(buf)
assert png.decode(buf.getvalue()).shape == (770, 1100, 3)
slam.shutdown()
assert not slam.live_viewer._http_thread.is_alive() and not slam.live_viewer._render_thread.is_alive()
assert not any(name.split(".")[0] in ("jax", "matplotlib", "PIL") for name, mod in sys.modules.items()
               if mod is not None)
print("OK")
"""


def test_port_imports_and_builds_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_no_jax_import_statements():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ceres_mono_orb_slam2_tpu)\b", re.M)
    files = list((REPO / "ceres_mono_orb_slam2_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
    # every module of the package imports (in this process, beside JAX)
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(m.name)


def test_renderer_matches_jax(rng):
    """The torch ray tracer against render_frames_device at 48x64, within
    1e-3 plus 1e-4 relative: the same f32 arithmetic, but the libraries
    round the length-3 dot products differently, and a last-ulp change of a
    texture coordinate moves a sample by the texture gradient (a few pixels
    of a frame differ by ~1.6e-3 at intensity ~60, 3e-5 relative)."""
    from ceres_mono_orb_slam2_tpu.utils import synthetic as jsyn
    from ceres_mono_orb_slam2_tpu_torch.utils import synthetic as tsyn

    h, w = 48, 64
    planes = tsyn.default_world(np.random.default_rng(5), extent=10.0)
    jplanes = jsyn.default_world(np.random.default_rng(5), extent=10.0)  # the same scene
    assert len(planes) == len(jplanes)
    for a, b in zip(planes, jplanes):
        np.testing.assert_array_equal(a.texture, b.texture)
        np.testing.assert_array_equal(a.origin, b.origin)
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    poses = [tsyn.camera_pose(k, "strafe", 0.12) for k in (0, 5, 11)]
    Rcw = np.stack([p[0] for p in poses]).astype(np.float32)
    tcw = np.stack([p[1] for p in poses]).astype(np.float32)
    ref = jsyn.render_frames_device(jplanes, K, Rcw, tcw, h, w)
    new = tsyn.render_frames_device(planes, K, Rcw, tcw, h, w)
    assert new.shape == ref.shape == (3, h, w)
    np.testing.assert_allclose(new, ref, rtol=1e-4, atol=1e-3)
    assert ref.std() > 5.0  # a textured view, not background


def test_slice_three_modules_exist_under_the_reference_names():
    """Each module of the relocalization and loop-closing slice has its
    counterpart in the port under the same name, with the same functions."""
    names = {
        "ops.lie": ["_sim3_W", "sim3_exp", "sim3_log", "sim3_inverse", "sim3_compose", "sim3_apply",
                    "sim3_adjoint", "sim3_ad", "sim3_right_jacobian_inv_approx", "se3_log",
                    "se3_to_matrix", "quat_to_rot"],
        "ops.matcher": ["hamming_pairwise"],
        "ops.bow": ["Vocabulary", "train_vocabulary", "seeded_vocabulary", "synth_vocabulary",
                    "parse_orbvoc_text", "dump_orbvoc_text", "_vocabulary_from_raw",
                    "make_transform_fn", "bow_vector", "l1_score"],
        "models.keyframe_database": ["KeyFrameDatabase"],
        "ops.pnp": ["_dlt_pose", "_p3p_pose", "ransac_pnp", "ransac_pnp_multi"],
        "ops.sim3solver": ["horn_sim3", "ransac_sim3"],
        "ops.sim3opt": ["optimize_sim3", "optimize_essential_graph"],
        "ops.optim": ["bundle_adjustment_cg"],
        "models.optimization": ["run_global_ba", "global_bundle_adjustment"],
        "models.loopclosing": ["LoopClosing"],
        "utils.geosim": ["GeoWorld", "make_geo_trajectory", "GeoExtractor", "frame_image"],
        "utils.convert": ["vocabulary_from_reference", "database_from_reference", "map_from_reference"],
    }
    for mod, attrs in names.items():
        tm = importlib.import_module(f"ceres_mono_orb_slam2_tpu_torch.{mod}")
        missing = [a for a in attrs if not hasattr(tm, a)]
        assert not missing, (mod, missing)
        if mod != "utils.convert":
            jm = importlib.import_module(f"ceres_mono_orb_slam2_tpu.{mod}")
            assert all(hasattr(jm, a) for a in attrs), mod
    from ceres_mono_orb_slam2_tpu_torch.models.tracking import Tracking

    assert hasattr(Tracking, "_relocalization") and "relocalizer" in Tracking.__init__.__code__.co_varnames


def test_slice_four_modules_exist_under_the_reference_names():
    """The one-card half of `parallel/` and the prepare / finish / consume
    split of the fused path have their counterparts under the same names."""
    names = {
        "parallel.multistream": ["StreamState", "StepResult", "make_multistream_step",
                                 "synthetic_stream_state", "make_multistream_local_ba"],
        "parallel.multisystem": ["MultiStreamSLAM"],
        "models.tracking": ["Tracking"],
        "utils.convert": ["stream_state_from_reference"],
    }
    for mod, attrs in names.items():
        tm = importlib.import_module(f"ceres_mono_orb_slam2_tpu_torch.{mod}")
        missing = [a for a in attrs if not hasattr(tm, a)]
        assert not missing, (mod, missing)
        if mod != "utils.convert":
            jm = importlib.import_module(f"ceres_mono_orb_slam2_tpu.{mod}")
            assert all(hasattr(jm, a) for a in attrs), mod
    from ceres_mono_orb_slam2_tpu.models.tracking import Tracking as JaxTracking
    from ceres_mono_orb_slam2_tpu.parallel.multistream import StepResult as JaxStepResult
    from ceres_mono_orb_slam2_tpu.parallel.multistream import StreamState as JaxStreamState
    from ceres_mono_orb_slam2_tpu.parallel.multisystem import MultiStreamSLAM as JaxMultiStreamSLAM
    from ceres_mono_orb_slam2_tpu_torch.models.tracking import Tracking
    from ceres_mono_orb_slam2_tpu_torch.parallel.multistream import StepResult, StreamState
    from ceres_mono_orb_slam2_tpu_torch.parallel.multisystem import MultiStreamSLAM

    for name in ("_fused_prepare", "_fused_finish", "_fused_consume", "_grab_fused",
                 "_grab_pipelined", "_start_pipeline", "_consume_pending", "flush_pipeline",
                 "_track_serial", "_start_copies"):
        assert hasattr(Tracking, name) and hasattr(JaxTracking, name), name
    assert StreamState._fields == JaxStreamState._fields
    assert StepResult._fields == JaxStepResult._fields
    for name in ("track_batch", "_finish_stream", "shutdown"):
        assert hasattr(MultiStreamSLAM, name) and hasattr(JaxMultiStreamSLAM, name), name
    ms = MultiStreamSLAM(port.utils.config.SlamConfig(), n_streams=2, device="cpu")
    for name in ("n_batched_frames", "n_single_frames", "phase_s", "streams"):
        assert hasattr(ms, name), name
    assert set(ms.phase_s) == {"prepare", "dispatch", "fetch", "consume", "frames"}


def test_slice_six_modules_exist_under_the_reference_names():
    """The CLI slice (data input, native host I/O, the lens renderer, the
    localization mode, the facade's getters and map persistence) has its
    counterparts under the JAX package's names."""
    names = {
        "cli": ["main"],
        "utils.datasets": ["ImageSequence", "load_tum", "load_kitti", "load_euroc", "load_auto"],
        "utils.native": ["available", "build_error", "get_lib", "parse_orbvoc_raw", "dump_orbvoc_native",
                         "imread_gray", "PrefetchLoader"],
        "utils.synthetic": ["make_sequence", "render_frames_device", "trajectory_positions", "ate_rmse"],
    }
    for mod, attrs in names.items():
        tm = importlib.import_module(f"ceres_mono_orb_slam2_tpu_torch.{mod}")
        jm = importlib.import_module(f"ceres_mono_orb_slam2_tpu.{mod}")
        assert all(hasattr(tm, a) and hasattr(jm, a) for a in attrs), mod
    from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
    from ceres_mono_orb_slam2_tpu.models.tracking import Tracking as JaxTracking
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.models.tracking import Tracking

    for name in ("activate_localization_mode", "deactivate_localization_mode", "n_tracked_points",
                 "get_tracked_map_points", "get_tracked_keypoints_un", "save_frame_trajectory_tum",
                 "save_map", "save_map_yaml", "load_map"):
        assert hasattr(MonoSLAM, name) and hasattr(JaxSLAM, name), name
    assert hasattr(Tracking, "_tracking_with_known_map") and hasattr(JaxTracking, "_tracking_with_known_map")
    # the native sources are the JAX package's, byte for byte
    for src in ("dataloader.cc", "orbvoc_io.cc"):
        assert ((REPO / "ceres_mono_orb_slam2_tpu_torch" / "native" / src).read_bytes()
                == (REPO / "ceres_mono_orb_slam2_tpu" / "native" / src).read_bytes()), src


def test_slice_nine_modules_exist_under_the_reference_names():
    """The multi-device half of `parallel/` has its counterparts under the
    JAX package's names, with the JAX package's parameters (the port's
    `shard_step_over_mesh` takes the device last)."""
    import inspect

    names = {
        "parallel.sharded_ba": ["bundle_adjustment_cg_sharded", "optimize_essential_graph_sharded"],
        "parallel.multistream": ["shard_step_over_mesh"],
    }
    for mod, attrs in names.items():
        tm = importlib.import_module(f"ceres_mono_orb_slam2_tpu_torch.{mod}")
        jm = importlib.import_module(f"ceres_mono_orb_slam2_tpu.{mod}")
        for a in attrs:
            tp = list(inspect.signature(getattr(tm, a)).parameters)
            jp = list(inspect.signature(getattr(jm, a)).parameters)
            assert tp[:len(jp)] == jp and tp[len(jp):] in ([], ["device"]), (mod, a, tp, jp)
    from ceres_mono_orb_slam2_tpu_torch.ops import optim, sim3opt

    for fn in (optim.bundle_adjustment_cg, sim3opt.optimize_essential_graph):  # axis_name's counterpart
        assert inspect.signature(fn).parameters["group"].default is None, fn.__name__
