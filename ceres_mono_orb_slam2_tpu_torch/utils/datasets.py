"""Dataset loaders: TUM, KITTI and EuRoC image sequences.

Port of `ceres_mono_orb_slam2_tpu/utils/datasets.py`. The mono_slam CLI reads
TUM-style `rgb.txt` lists (reference main.cc:22-47 LoadImages); the KITTI and
EuRoC layouts follow the reference README (README.md:186-210). Images load
lazily as (h, w) float32 grayscale.

The reader is the native decoder of `utils/native.py` (C++, zlib). Its plain
version is `imread_gray_plain` below, stdlib `zlib` and numpy only (the card
has no PIL): a PNG or binary-PGM decoder that gives the native decoder's
bits and also reads what the native decoder declines (palette and sub-byte
PNGs); an interlaced PNG or another format raises an error naming the file.
Grayscale is PIL's convert("L") luma, L = (19595 R + 38470 G + 7471 B +
0x8000) >> 16; 16-bit samples keep their high byte (the reference's
cv::imread 16 -> 8 conversion).
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


def _luma(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    r, g, b = (a.astype(np.uint32) for a in (r, g, b))
    return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-scanline PNG filters: (h, stride) uint8 scanlines."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:  # Sub: a running sum along the pixels, per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:  # Up
            cur = line + prev
        elif ft in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(stride)
            lb, pb = line.tobytes(), prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = pb[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = pb[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pbb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pbb and pa <= pc else (b if pbb <= pc else c)
                cur[i] = (lb[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: corrupt PNG (filter type {ft})")
        out[y] = cur
        prev = out[y]
    return out


def _decode_png(buf: bytes, path: str) -> np.ndarray:
    pos, idat, plte, ihdr = 8, [], None, None
    while pos + 8 <= len(buf):
        n = int.from_bytes(buf[pos:pos + 4], "big")
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        if len(data) < n:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        if tag == b"IHDR" and n >= 13:
            ihdr = data
        elif tag == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError(f"{path}: corrupt PNG (no IHDR or IDAT)")
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    depth, ctype, interlace = ihdr[8], ihdr[9], ihdr[12]
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or not (0 < w <= 65535 and 0 < h <= 65535):
        raise ValueError(f"{path}: unsupported PNG (colour type {ctype}, depth {depth}, {w}x{h})")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from None
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: corrupt PNG ({raw.size} bytes of pixel data for {w}x{h})")
    lines = _unfilter(raw, h, stride, max(1, ch * depth // 8), path)
    if depth == 16:
        s = lines.reshape(h, w, ch, 2)[..., 0]  # the high byte of each sample
    elif depth == 8:
        s = lines.reshape(h, w, ch)
    else:  # 1, 2 or 4 bits a sample (gray or palette only): MSB first
        bits = np.unpackbits(lines, axis=1).reshape(h, -1, depth)
        s = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        s = s[:, :w, None]
        if ctype == 0:
            s = s * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        idx = s[..., 0]
        if int(idx.max()) >= len(plte):
            raise ValueError(f"{path}: palette index beyond the PLTE chunk")
        rgb = plte[idx]
        return _luma(rgb[..., 0], rgb[..., 1], rgb[..., 2]).astype(np.float32)
    if ch >= 3:
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
    if buf[:8] == _PNG_MAGIC:
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
