"""Port of tests/test_datasets.py and tests/test_native.py: the TUM, KITTI and
EuRoC layouts, `load_auto` driving the port's MonoSLAM, and the native host
I/O (PNG / PGM decode, the prefetching loader, ORBvoc text parse and dump)
against its plain versions.

Stated bars: decoded images are bit-exact, the native decoder, the plain
reader and the JAX package's PIL reader (`_imread_gray_pil`) alike; a
loader's image differs from the rendered float frame by its 8-bit
quantisation only (mean under 1 grey level); the native and Python ORBvoc
paths give identical trees (weights to 1e-6 relative). PIL writes the test
files; the port's reader never imports it. About 25 s alone on two
threads."""

import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from ceres_mono_orb_slam2_tpu.utils import synthetic as jsyn
from ceres_mono_orb_slam2_tpu.utils.datasets import _imread_gray_pil
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.utils import datasets, native, synthetic
from ceres_mono_orb_slam2_tpu_torch.utils.datasets import ImageSequence, imread_gray_plain, load_auto

torch.set_num_threads(2)



@pytest.fixture()
def needs_native():
    """Skip where the native library cannot be built (decided in the test,
    not while the module is imported: a build must not run at collection)."""
    if not native.available():
        pytest.skip(f"native library unavailable: {native.build_error()}")


@pytest.fixture(scope="module")
def rendered():
    # the JAX package's cached render of tests/test_datasets.py (the port's
    # make_sequence renders the same bits)
    return make_sequence(n_frames=6, seed=11, motion="strafe", step=0.12)


def test_numpy_renderer_matches_jax():
    """The port's make_sequence (the CLI's --synthetic renderer) renders the
    JAX package's images and poses to the bit, at a small size."""
    a = jsyn.make_sequence(n_frames=2, h=60, w=80, fx=62.5, fy=62.5, seed=11, step=0.12, cache=False)
    b = synthetic.make_sequence(n_frames=2, h=60, w=80, fx=62.5, fy=62.5, seed=11, step=0.12)
    for f in ("images", "poses_Rcw", "poses_tcw", "timestamps", "K"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    assert a.images.std() > 5.0


def _save_png(path, img):
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), mode="L").save(path)


def _write_tum(d, seq, names=None):
    (d / "rgb").mkdir(parents=True)
    with open(d / "rgb.txt", "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for i in range(seq.n_frames):
            name = names(i) if names else f"rgb/{seq.timestamps[i]:.6f}.png"
            _save_png(str(d / name), seq.images[i])
            f.write(f"{seq.timestamps[i]:.6f} {name}\n")


def test_tum_format(tmp_path, rendered):
    seq = rendered
    _write_tum(tmp_path / "tum", seq)
    ds = load_auto(str(tmp_path / "tum"))
    assert len(ds) == seq.n_frames
    img, ts = ds[2]
    assert img.shape == seq.images[2].shape and img.dtype == np.float32
    assert abs(ts - seq.timestamps[2]) < 1e-6
    assert np.abs(img - seq.images[2]).mean() < 1.0  # u8 quantisation only


def test_kitti_format(tmp_path, rendered):
    seq = rendered
    d = tmp_path / "kitti"
    (d / "image_0").mkdir(parents=True)
    np.savetxt(d / "times.txt", seq.timestamps, fmt="%.6e")
    for i in range(seq.n_frames):
        _save_png(str(d / "image_0" / ("%06d.png" % i)), seq.images[i])
    ds = load_auto(str(d))
    assert len(ds) == seq.n_frames
    img, ts = ds[1]
    assert np.abs(img - seq.images[1]).mean() < 1.0


def test_euroc_format(tmp_path, rendered):
    seq = rendered
    d = tmp_path / "euroc"
    data = d / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    with open(d / "mav0" / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i in range(seq.n_frames):
            ns = int(seq.timestamps[i] * 1e9)
            _save_png(str(data / ("%d.png" % ns)), seq.images[i])
            f.write(f"{ns},{ns}.png\n")
    ds = load_auto(str(d))
    assert len(ds) == seq.n_frames
    img, ts = ds[3]
    assert abs(ts - seq.timestamps[3]) < 1e-6
    assert np.abs(img - seq.images[3]).mean() < 1.0
    with pytest.raises(ValueError, match="unrecognized dataset layout"):
        load_auto(str(tmp_path))


def test_dataset_drives_slam(tmp_path, rendered):
    """The loader's frames track through the port's system (the CLI's
    --images route)."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes

    seq = rendered
    _write_tum(tmp_path / "tum2", seq, names=lambda i: f"rgb/{i}.png")
    ds = load_auto(str(tmp_path / "tum2"))
    cfg = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
                     orb=ORBConfig(n_features=1500),
                     shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                                         max_ba_points=1024, max_ba_obs=4096))
    slam = MonoSLAM(cfg, device="cpu")
    tracked = sum(slam.track_monocular(img, ts) is not None for img, ts in ds.iter_prefetch())
    assert slam.get_tracking_state() == "OK"
    assert tracked >= 3


# ------------------------------------------------------------- image decode


def _png(path, w, h, ctype, depth, rows, filters, plte=None):
    """A PNG written by hand: `rows` (h, stride) uint8 scanlines, each
    filtered with the type `filters[y]` (0-4)."""
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    raw, prev = bytearray(), np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ft = filters[y]
        if ft == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        else:
            pred = [np.zeros_like(cur), a, prev, (a + prev) >> 1][ft]
        raw += bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return len(data).to_bytes(4, "big") + tag + data + zlib.crc32(tag + data).to_bytes(4, "big")

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([depth, ctype, 0, 0, 0])
    body = chunk(b"IHDR", ihdr) + (chunk(b"PLTE", plte.tobytes()) if plte is not None else b"")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.fixture()
def img_dir(tmp_path):
    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)).save(tmp_path / "rgb.png")
    Image.fromarray(rng.integers(0, 256, (41, 29), dtype=np.uint8), "L").save(tmp_path / "gray.png")
    Image.fromarray(rng.integers(0, 256, (16, 24, 4), dtype=np.uint8), "RGBA").save(tmp_path / "rgba.png")
    a16 = ((np.arange(48 * 64, dtype=np.uint32).reshape(48, 64) * 977) % 65536).astype(np.uint16)
    Image.fromarray(a16).save(tmp_path / "t16.png")
    with open(tmp_path / "img.pgm", "wb") as f:
        f.write(b"P5\n# comment\n29 13\n255\n" + rng.integers(0, 256, (13, 29), dtype=np.uint8).tobytes())
    with open(tmp_path / "img16.pgm", "wb") as f:
        f.write(b"P5\n29 13\n65535\n" + rng.integers(0, 65536, (13, 29)).astype(">u2").tobytes())
    # every PNG filter type, one per row, in gray, RGB and 16-bit RGBA
    for name, ctype, depth, ch in (("filters_l.png", 0, 8, 1), ("filters_rgb.png", 2, 8, 3),
                                   ("filters_rgba16.png", 6, 16, 4)):
        w, h = 23, 15
        rows = rng.integers(0, 256, (h, w * ch * depth // 8), dtype=np.uint8)
        _png(str(tmp_path / name), w, h, ctype, depth, rows, [y % 5 for y in range(h)])
    return tmp_path


@pytest.mark.parametrize("name", ["rgb.png", "gray.png", "rgba.png", "t16.png", "img.pgm", "img16.pgm"])
def test_decoders_match_pil(img_dir, name):
    """The plain reader, the native decoder and the JAX package's PIL
    reader give the same bits; 16-bit samples keep their high byte."""
    p = str(img_dir / name)
    want = _imread_gray_pil(p)
    got = imread_gray_plain(p)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if native.available():
        np.testing.assert_array_equal(native.imread_gray(p), want)


@pytest.mark.parametrize("name", ["filters_l.png", "filters_rgb.png", "filters_rgba16.png"])
def test_every_png_filter_matches_native(needs_native, img_dir, name):
    p = str(img_dir / name)
    nat = native.imread_gray(p)
    assert nat is not None
    np.testing.assert_array_equal(imread_gray_plain(p), nat)


def test_plain_reader_covers_what_native_declines(tmp_path):
    """Palette and 1-bit PNGs, which the native decoder declines, read
    through the plain reader to PIL's bits; an interlaced PNG, a corrupt
    header or an unknown format raises an error naming the file."""
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (8, 8), np.uint8), "L").convert("P").save(tmp_path / "pal.png")
    Image.fromarray(rng.integers(0, 256, (9, 13, 3), np.uint8)).quantize(colors=16).save(tmp_path / "pal4.png")
    Image.fromarray(rng.integers(0, 2, (7, 11), np.uint8) * 255, "L").convert("1").save(tmp_path / "bit1.png")
    for name in ("pal.png", "pal4.png", "bit1.png"):
        p = str(tmp_path / name)
        if native.available():
            assert native.imread_gray(p) is None, name
        np.testing.assert_array_equal(datasets.imread_gray(p), _imread_gray_pil(p), err_msg=name)
    good = (tmp_path / "pal.png").read_bytes()
    ihdr = good.index(b"IHDR")
    (tmp_path / "interlaced.png").write_bytes(good[:ihdr + 16] + b"\x01" + good[ihdr + 17:])
    with open(tmp_path / "corrupt.png", "wb") as f:
        f.write(bytes([137]) + b"garbage" * 300)
    (tmp_path / "img.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(100))
    for name in ("interlaced.png", "corrupt.png", "img.jpg"):
        p = str(tmp_path / name)
        if native.available():
            assert native.imread_gray(p) is None, name
        with pytest.raises(ValueError, match=name):
            datasets.imread_gray(p)


def test_prefetch_loader_order_and_content(needs_native, tmp_path):
    """The native worker delivers frames in order, bit-identical to a
    synchronous decode, with a capacity below the sequence length."""
    rng = np.random.default_rng(3)
    paths, imgs = [], []
    for i in range(17):
        img = rng.integers(0, 256, (12, 18), dtype=np.uint8)
        p = str(tmp_path / f"f{i:03d}.png")
        Image.fromarray(img, "L").save(p)
        paths.append(p)
        imgs.append(img)
    loader = native.PrefetchLoader(paths, imread_gray_plain, capacity=3)
    got = list(loader)
    loader.close()
    assert len(got) == 17
    for g, img in zip(got, imgs):
        np.testing.assert_array_equal(g, img.astype(np.float32))


def test_iter_prefetch_matches_getitem(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"s{i}.png")
        Image.fromarray(rng.integers(0, 256, (10, 11), np.uint8), "L").save(p)
        paths.append(p)
    seq = ImageSequence(paths, np.arange(6, dtype=np.float64) * 0.1)
    sync = [seq[i] for i in range(6)]
    pre = list(seq.iter_prefetch())
    monkeypatch.setattr(native, "available", lambda: False)  # the plain path
    plain = list(seq.iter_prefetch(4))
    assert len(pre) == 6 and len(plain) == 4
    for (a, ta), (b, tb) in zip(pre, sync):
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    for (a, ta), (b, tb) in zip(plain, sync):
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    assert datasets.reader().startswith("plain Python")


# --------------------------------------------------------------- ORBvoc text


def test_orbvoc_native_python_identical(needs_native, tmp_path, monkeypatch):
    """Native parse and dump agree with the Python ones field for field on a
    k=4 L=3 vocabulary round-tripped through the ORBvoc.txt format."""
    voc = bow.synth_vocabulary(k=4, levels=3, seed=1)
    p_native, p_python = str(tmp_path / "voc_native.txt"), str(tmp_path / "voc_python.txt")
    bow.dump_orbvoc_text(voc, p_native)
    v_nat = bow.parse_orbvoc_text(p_native)
    with monkeypatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        bow.dump_orbvoc_text(voc, p_python)
        v_py = bow.parse_orbvoc_text(p_python)
        v_py_of_native = bow.parse_orbvoc_text(p_native)
    for f in ("node_desc", "children", "is_leaf", "word_id", "node_level"):
        np.testing.assert_array_equal(getattr(v_nat, f), getattr(v_py, f), err_msg=f)
        np.testing.assert_array_equal(getattr(v_py_of_native, f), getattr(v_py, f), err_msg=f)
    np.testing.assert_allclose(v_nat.word_weight, v_py.word_weight, rtol=1e-6)
    assert len(v_nat.node_desc) == len(voc.node_desc)
    assert v_nat.k == voc.k and v_nat.levels == voc.levels
    np.testing.assert_allclose(np.sort(v_nat.word_weight), np.sort(voc.word_weight), atol=1e-5)


def test_orbvoc_dump_wide_branching(needs_native, tmp_path):
    """A k=80 single-level star tree round-trips through the native writer
    with no child dropped."""
    rng = np.random.default_rng(9)
    k = 80
    node_desc = np.zeros((k + 1, 32), np.uint8)
    node_desc[1:] = rng.integers(0, 256, (k, 32), np.uint8)
    children = np.full((k + 1, k), -1, np.int32)
    children[0] = np.arange(1, k + 1, dtype=np.int32)
    word_id = np.concatenate([[-1], np.arange(k)]).astype(np.int32)
    weights = rng.uniform(0.1, 2.0, k).astype(np.float32)
    p = str(tmp_path / "wide.txt")
    assert native.dump_orbvoc_native(p, k, 1, node_desc, children, word_id, weights)
    v = bow.parse_orbvoc_text(p)
    assert len(v.node_desc) == k + 1
    np.testing.assert_array_equal(np.sort(v.node_desc[1:], axis=0), np.sort(node_desc[1:], axis=0))


def test_orbvoc_count_and_build_location(needs_native, tmp_path):
    voc = bow.synth_vocabulary(k=3, levels=2, seed=2)
    p = str(tmp_path / "voc.txt")
    bow.dump_orbvoc_text(voc, p)
    assert native.get_lib().orbvoc_count(p.encode()) == len(voc.node_desc) - 1  # minus the root
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == ".kernels_build" and native.build_error() is None
