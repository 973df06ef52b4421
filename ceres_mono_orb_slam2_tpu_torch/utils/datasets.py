"""Dataset loaders: TUM, KITTI and EuRoC image sequences.

Port of `ceres_mono_orb_slam2_tpu/utils/datasets.py`. The mono_slam CLI reads
TUM-style `rgb.txt` lists (reference main.cc:22-47 LoadImages); the KITTI and
EuRoC layouts follow the reference README (README.md:186-210). Images load
lazily as (h, w) float32 grayscale.

The reader is the native decoder of `utils/native.py` (C++, zlib). Its plain
version is `imread_gray_plain` below, stdlib `zlib` and numpy only (the card
has no PIL; the PNG parse is `utils/png.py`'s): a PNG or binary-PGM decoder
that gives the native decoder's bits and also reads what the native decoder
declines (palette and sub-byte PNGs); an interlaced PNG or another format
raises an error naming the file.
Grayscale is PIL's convert("L") luma, L = (19595 R + 38470 G + 7471 B +
0x8000) >> 16; 16-bit samples keep their high byte (the reference's
cv::imread 16 -> 8 conversion).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ceres_mono_orb_slam2_tpu_torch.utils import png


def _luma(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    r, g, b = (a.astype(np.uint32) for a in (r, g, b))
    return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16


def _decode_png(buf: bytes, path: str) -> np.ndarray:
    s, ctype, plte = png.read_samples(buf, path)
    if ctype == 3:
        idx = s[..., 0]
        if int(idx.max()) >= len(plte):
            raise ValueError(f"{path}: palette index beyond the PLTE chunk")
        rgb = plte[idx]
        return _luma(rgb[..., 0], rgb[..., 1], rgb[..., 2]).astype(np.float32)
    if s.shape[-1] >= 3:
        return _luma(s[..., 0], s[..., 1], s[..., 2]).astype(np.float32)
    return s[..., 0].astype(np.float32)


def _decode_pgm(buf: bytes, path: str) -> np.ndarray:
    """Binary PGM (P5), 8 or 16 bits a sample (the high byte kept)."""
    pos, vals = 2, []
    while len(vals) < 3:
        while pos < len(buf) and (buf[pos] in b" \t\r\n" or buf[pos] == ord("#")):
            if buf[pos] == ord("#"):
                while pos < len(buf) and buf[pos] != ord("\n"):
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(buf) and 48 <= buf[pos] <= 57:
            pos += 1
        if pos == start:
            raise ValueError(f"{path}: corrupt PGM header")
        vals.append(int(buf[start:pos]))
    pos += 1  # one whitespace byte after maxval
    w, h, maxval = vals
    step = 2 if maxval > 255 else 1
    if w <= 0 or h <= 0 or pos + w * h * step > len(buf):
        raise ValueError(f"{path}: corrupt PGM ({w}x{h}, {len(buf) - pos} bytes of pixels)")
    px = np.frombuffer(buf, np.uint8, count=w * h * step, offset=pos)
    return px[::step].reshape(h, w).astype(np.float32)


def imread_gray_plain(path: str) -> np.ndarray:
    """The plain reader: PNG or binary PGM to (h, w) float32 grayscale."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] == png.MAGIC:
        return _decode_png(buf, path)
    if buf[:2] == b"P5":
        return _decode_pgm(buf, path)
    raise ValueError(f"{path}: not a PNG or binary PGM image")


def imread_gray(path: str) -> np.ndarray:
    """The native decoder, or the plain reader for what it declines (or
    where the native library did not build)."""
    from ceres_mono_orb_slam2_tpu_torch.utils import native

    img = native.imread_gray(path)
    return img if img is not None else imread_gray_plain(path)


def reader() -> str:
    """Which image reader this process uses, for the user to see."""
    from ceres_mono_orb_slam2_tpu_torch.utils import native

    if native.available():
        return f"native ({native.library_path().name})"
    return f"plain Python (native library unavailable: {(native.build_error() or '').strip()[-300:]})"


@dataclass
class ImageSequence:
    paths: List[str]
    timestamps: np.ndarray

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> Tuple[np.ndarray, float]:
        return imread_gray(self.paths[i]), float(self.timestamps[i])

    def iter_prefetch(self, n: Optional[int] = None, capacity: int = 4) -> Iterator[Tuple[np.ndarray, float]]:
        """Yield (image, timestamp) with the native loader decoding up to
        `capacity` frames ahead of the consumer, or synchronously where the
        native library did not build."""
        from ceres_mono_orb_slam2_tpu_torch.utils import native

        n = len(self.paths) if n is None else min(n, len(self.paths))
        if not native.available():
            for i in range(n):
                yield self[i]
            return
        loader = native.PrefetchLoader(self.paths[:n], imread_gray_plain, capacity=capacity)
        try:
            for i, img in enumerate(loader):
                yield img, float(self.timestamps[i])
        finally:
            loader.close()


def load_tum(directory: str, list_file: str = "rgb.txt") -> ImageSequence:
    """TUM RGB-D layout: `rgb.txt` lines 'timestamp path', '#' comments
    (reference LoadImages, main.cc:22-47)."""
    paths, stamps = [], []
    with open(os.path.join(directory, list_file)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            stamps.append(float(parts[0]))
            paths.append(os.path.join(directory, parts[1]))
    return ImageSequence(paths, np.array(stamps, np.float64))


def load_kitti(directory: str) -> ImageSequence:
    """KITTI odometry layout: image_0/%06d.png and times.txt."""
    times = np.atleast_1d(np.loadtxt(os.path.join(directory, "times.txt"), dtype=np.float64))
    img_dir = os.path.join(directory, "image_0")
    return ImageSequence([os.path.join(img_dir, "%06d.png" % i) for i in range(len(times))], times)


def load_euroc(directory: str, timestamp_file: Optional[str] = None) -> ImageSequence:
    """EuRoC MAV layout: mav0/cam0/data/<ns>.png, the timestamps from a list
    (the reference's configs/EuRoC_TimeStamps) or from mav0/cam0/data.csv."""
    data_dir = os.path.join(directory, "mav0", "cam0", "data")
    if timestamp_file:
        with open(timestamp_file) as f:
            stamps_ns = [int(line.strip()) for line in f if line.strip()]
    else:
        stamps_ns = []
        with open(os.path.join(directory, "mav0", "cam0", "data.csv")) as f:
            for line in f:
                if not line.startswith("#"):
                    stamps_ns.append(int(line.split(",")[0]))
    paths = [os.path.join(data_dir, "%d.png" % t) for t in stamps_ns]
    return ImageSequence(paths, np.array(stamps_ns, np.float64) * 1e-9)


def load_auto(path: str) -> ImageSequence:
    if os.path.exists(os.path.join(path, "rgb.txt")):
        return load_tum(path)
    if os.path.exists(os.path.join(path, "times.txt")):
        return load_kitti(path)
    if os.path.exists(os.path.join(path, "mav0")):
        return load_euroc(path)
    raise ValueError(f"unrecognized dataset layout at {path}")
