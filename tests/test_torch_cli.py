"""The port's mono_slam CLI on the CPU (`--device cpu`), in process:
`--synthetic` writes the four output files; `--images` over a TUM folder
with a dumped vocabulary and `--stats-out`, then `--load-map
--localization` over the same folder, where the first frame relocalizes
against the loaded map and no keyframe is added; `--profile-dir` writes a
torch.profiler trace; `--viewer --live-viewer 0` writes its snapshots and
stops its threads; `--device cuda` without a card raises. About 65 s alone
on two threads."""

import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from ceres_mono_orb_slam2_tpu_torch import cli, viewer
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.ops.orb import ORBExtractor
from ceres_mono_orb_slam2_tpu_torch.utils import png
from ceres_mono_orb_slam2_tpu_torch.utils.config import ORBConfig
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence

torch.set_num_threads(2)
OUTPUTS = ("KeyFrameTrajectory.txt", "FrameTrajectory.txt", "map.npz", "map.yaml")
CONFIG = """%YAML:1.0
Camera.fx: 500.0
Camera.fy: 500.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.fps: 30.0
Camera.RGB: 1
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "TUM.yaml"
    p.write_text(CONFIG)
    return str(p)


def _tum_rows(path):
    rows = np.array([line.split() for line in open(path).read().strip().split("\n")], np.float64)
    assert rows.shape[1] == 8 and np.isfinite(rows).all()
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
    return rows


def _exit_line(out: str):
    """(frames, state, keyframes, map points) of the CLI's summary line."""
    line = next(ln for ln in out.splitlines() if ln.startswith("tracked "))
    w = line.replace(",", "").split()
    return int(w[1]), w[4], int(w[5]), int(w[7])


def test_synthetic_run_writes_the_four_files(config, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main(["--config", config, "--synthetic", "8", "--output-dir", str(out), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    n, state, n_kfs, n_mps = _exit_line(text)
    assert n == 8 and state == "OK" and n_kfs >= 2 and n_mps > 100
    assert "median tracking time: " in text and "mean tracking time: " in text
    for name in OUTPUTS:
        assert (out / name).exists(), name
    assert len(_tum_rows(out / "KeyFrameTrajectory.txt")) == n_kfs
    assert len(_tum_rows(out / "FrameTrajectory.txt")) >= 3
    assert np.load(out / "map.npz")["kf_ids"].shape == (n_kfs,)
    assert (out / "map.yaml").read_text().startswith("%YAML:1.0\n---\n")


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A 6-frame TUM folder of the strafe and an ORBvoc.txt trained on its
    first frame."""
    d = tmp_path_factory.mktemp("tum")
    seq = make_sequence(n_frames=6, seed=11, motion="strafe", step=0.12)  # the JAX package's cached render
    (d / "rgb").mkdir()
    with open(d / "rgb.txt", "w") as f:
        f.write("# timestamp filename\n")
        for i in range(seq.n_frames):
            Image.fromarray(np.clip(seq.images[i] + 0.5, 0, 255).astype(np.uint8), "L").save(d / f"rgb/{i}.png")
            f.write(f"{seq.timestamps[i]:.6f} rgb/{i}.png\n")
    feats = ORBExtractor(ORBConfig(n_features=1500), device="cpu").extract(seq.images[0])
    voc = bow.train_vocabulary(feats.desc[0][feats.valid[0]].numpy(), k=8, levels=3, seed=0, device="cpu")
    bow.dump_orbvoc_text(voc, str(d / "voc.txt"))
    return d


def test_images_then_localization_against_the_saved_map(config, tum_dir, tmp_path, capsys):
    out1, out2 = tmp_path / "map_run", tmp_path / "loc_run"
    voc = str(tum_dir / "voc.txt")
    assert cli.main(["--config", config, "--images", str(tum_dir), "--voc", voc, "--output-dir", str(out1),
                     "--stats-out", str(tmp_path / "s1.jsonl"), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "image reader: " in text
    n, state, n_kfs, n_mps = _exit_line(text)
    assert n == 6 and state == "OK" and n_kfs >= 2
    stats = [json.loads(line) for line in open(tmp_path / "s1.jsonl")]
    assert stats and all(s["ok"] for s in stats)
    assert len(_tum_rows(out1 / "FrameTrajectory.txt")) == len(stats)

    assert cli.main(["--config", config, "--images", str(tum_dir), "--voc", voc, "--output-dir", str(out2),
                     "--load-map", str(out1 / "map.npz"), "--localization",
                     "--stats-out", str(tmp_path / "s2.jsonl"), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"loaded map: {n_kfs} keyframes, {n_mps} map points" in text
    n2, state2, n_kfs2, _ = _exit_line(text)
    assert n2 == 6 and state2 == "OK" and n_kfs2 == n_kfs  # localization adds no keyframe
    stats2 = [json.loads(line) for line in open(tmp_path / "s2.jsonl")]
    assert len(stats2) == 6  # every frame tracked, none went to initialization
    assert stats2[0]["method"] == "reloc" and all(s["ok"] for s in stats2)
    assert len(_tum_rows(out2 / "FrameTrajectory.txt")) == 6


def test_profile_dir_writes_a_trace(config, tmp_path, capsys):
    trace = tmp_path / "trace"
    assert cli.main(["--config", config, "--synthetic", "2", "--output-dir", str(tmp_path / "out"),
                     "--profile-dir", str(trace), "--device", "cpu"]) == 0
    assert "profiler trace written to" in capsys.readouterr().out
    files = list(trace.glob("*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())["traceEvents"]


def test_refuses_what_it_cannot_do(config):
    if not torch.cuda.is_available():  # the card is the default, and never swapped for the CPU
        for device in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(["--config", config, "--synthetic", "2", *device])
    with pytest.raises(SystemExit):  # the JAX CLI parses the flag and never reads it
        cli.main(["--config", config, "--synthetic", "2", "--device", "cpu", "--train-voc-frames", "4"])


def test_viewers(config, tmp_path, monkeypatch, capsys):
    """`--viewer --live-viewer 0`: snapshots every 10 frames into viewer_out/
    of the current directory, the live viewer served during the run and
    stopped with it."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--config", config, "--synthetic", "12", "--viewer", "--live-viewer", "0",
                     "--output-dir", "out", "--device", "cpu"]) == 0
    assert _exit_line(capsys.readouterr().out)[:2] == (12, "OK")
    assert sorted(p.name for p in (tmp_path / "viewer_out").iterdir()) == ["map_00010.png"]
    with open(tmp_path / "viewer_out" / "map_00010.png", "rb") as f:
        assert png.decode(f.read()).shape == (viewer.MAP_H, viewer.MAP_W, 3)
    assert not [t for t in threading.enumerate() if t.name.startswith("viewer-") and t.is_alive()]
