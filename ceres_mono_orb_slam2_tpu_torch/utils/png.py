"""PNG files with the standard library's `zlib` and numpy.

The card has neither PIL nor matplotlib, so the port writes and reads its
PNGs here. `encode` writes an 8-bit grayscale or RGB image as IHDR, one IDAT
of unfiltered scanlines and IEND: the viewers' renders (`viewer.py`) and the
image folders chip_smoke.py writes. `read_samples` parses any non-interlaced
PNG to its samples; the plain dataset reader (`utils/datasets.py`) turns
them into grayscale. `decode` gives back what `encode` wrote.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
# the live viewer encodes every render, and zlib level 1 deflates a frame
# several times faster than zlib's default 6 for a file about a quarter larger
_ZLIB_LEVEL = 1


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode(img: np.ndarray) -> bytes:
    """An (h, w) grayscale or (h, w, 3) RGB uint8 image as PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"PNG encode takes (h, w) or (h, w, 3) uint8, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + img[0].size), np.uint8)  # filter byte 0 (None) before each scanline
    raw[:, 1:] = img.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    return (MAGIC + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), _ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def write(path, img: np.ndarray):
    """`encode(img)` into a file name or a binary file-like object."""
    data = encode(img)
    if hasattr(path, "write"):
        path.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


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


def read_samples(buf: bytes, path: str = "PNG"):
    """Parse a PNG: (samples (h, w, c) uint8, colour type, palette (n, 3) or
    None). 16-bit samples keep their high byte; 1-, 2- and 4-bit gray
    samples are scaled to 0-255, palette indices are not. An interlaced PNG
    or a corrupt one raises ValueError naming `path`."""
    if buf[:8] != MAGIC:
        raise ValueError(f"{path}: not a PNG")
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
        return lines.reshape(h, w, ch, 2)[..., 0], ctype, plte  # the high byte of each sample
    if depth == 8:
        return lines.reshape(h, w, ch), ctype, plte
    # 1, 2 or 4 bits a sample (gray or palette only): MSB first
    bits = np.unpackbits(lines, axis=1).reshape(h, -1, depth)
    s = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
    s = s[:, :w, None]
    if ctype == 0:
        s = s * np.uint8(255 // ((1 << depth) - 1))
    return s, ctype, plte


def decode(buf: bytes) -> np.ndarray:
    """An 8-bit grayscale or RGB PNG as (h, w) or (h, w, 3) uint8."""
    s, ctype, _ = read_samples(buf)
    if ctype == 0:
        return s[..., 0]
    if ctype == 2:
        return s
    raise ValueError(f"PNG colour type {ctype} is neither gray nor RGB")
