"""ctypes bindings for the native C++ host I/O: ORBvoc text parse and dump,
PNG / PGM decode, and a prefetching image loader.

Port of `ceres_mono_orb_slam2_tpu/utils/native.py`. The sources in
`ceres_mono_orb_slam2_tpu_torch/native/` are copies of the JAX package's.
They run on the host only (no kernel): at first use one `g++ ... -lz
-lpthread` builds them into a shared library keyed by a hash of the sources
and flags, in `.kernels_build/` at the root of the checkout, beside the CUDA
kernels' library. Nothing here runs at import.

Where the library cannot be built (no g++ or no zlib headers), `available()`
is False and `build_error()` says why; the callers then take the plain
Python reader of `utils/datasets.py` and the Python ORBvoc scanner of
`ops/bow.py`, which give identical results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG.parent / ".kernels_build"
SOURCES = ("orbvoc_io.cc", "dataloader.cc")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz", "-lpthread"]

# None: not tried yet; False: tried and failed (not retried: imread_gray runs
# once a frame); else the loaded library
_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libslam_native_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the sources into the hashed library unless it exists. Returns
    its path, or None with the reason in `_build_error`."""
    global _build_error
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = f"{' '.join(cmd)}: {e}"
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        _build_error = proc.stderr[-2000:] or f"g++ exited with {proc.returncode}"
        return None
    os.replace(tmp, out)  # atomic when two processes build at once
    return out


def get_lib():
    """The loaded library, built on first call (and once more if the cached
    one does not load); None where it cannot be built or loaded (the failure
    is kept, not retried)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib or None
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        lib = None
        for _ in range(2):
            path = _build()
            if path is None:
                break
            try:
                lib = ctypes.CDLL(str(path))
                break
            except OSError as e:  # a library built elsewhere (another glibc): build it again
                _build_error = str(e)
                path.unlink(missing_ok=True)
        if lib is None:
            _lib = False
            return None
        c = ctypes
        lib.orbvoc_count.restype = c.c_long
        lib.orbvoc_count.argtypes = [c.c_char_p]
        lib.orbvoc_parse.restype = c.c_long
        lib.orbvoc_parse.argtypes = [c.c_char_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_long, c.POINTER(c.c_int), c.POINTER(c.c_int)]
        lib.orbvoc_dump.restype = c.c_int
        lib.orbvoc_dump.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_int,
                                    c.c_void_p, c.c_void_p, c.c_long]
        lib.img_decode_file.restype = c.c_int
        lib.img_decode_file.argtypes = [c.c_char_p, c.c_void_p, c.POINTER(c.c_int),
                                        c.POINTER(c.c_int), c.c_long]
        lib.img_probe_file.restype = c.c_int
        lib.img_probe_file.argtypes = [c.c_char_p, c.POINTER(c.c_int), c.POINTER(c.c_int)]
        lib.loader_create.restype = c.c_void_p
        lib.loader_create.argtypes = [c.POINTER(c.c_char_p), c.c_long, c.c_int]
        lib.loader_next.restype = c.c_int
        lib.loader_next.argtypes = [c.c_void_p, c.c_void_p, c.POINTER(c.c_int),
                                    c.POINTER(c.c_int), c.c_long]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    return _build_error


# ---------------------------------------------------------------- ORBvoc text


def parse_orbvoc_raw(path: str):
    """Native line scan of an ORBvoc.txt: (k, levels, parents int32 (n,),
    leafs bool (n,), descs uint8 (n, 32), weights float32 (n,)), or None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.orbvoc_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    parents = np.empty(n, np.int32)
    leafs = np.empty(n, np.uint8)
    descs = np.empty((n, 32), np.uint8)
    weights = np.empty(n, np.float32)
    k, levels = ctypes.c_int(), ctypes.c_int()
    got = lib.orbvoc_parse(path.encode(), parents.ctypes.data, leafs.ctypes.data, descs.ctypes.data,
                           weights.ctypes.data, n, ctypes.byref(k), ctypes.byref(levels))
    if got < 0:
        raise IOError(f"native ORBvoc parse failed for {path}")
    return int(k.value), int(levels.value), parents[:got], leafs[:got].astype(bool), descs[:got], weights[:got]


def dump_orbvoc_native(path: str, k: int, levels: int, node_desc: np.ndarray, children: np.ndarray,
                       word_id: np.ndarray, word_weight: np.ndarray) -> bool:
    """Write an ORBvoc.txt with the native writer; False without the
    library or on a write failure."""
    lib = get_lib()
    if lib is None:
        return False
    node_desc = np.ascontiguousarray(node_desc, np.uint8)
    children = np.ascontiguousarray(children, np.int32)
    word_id = np.ascontiguousarray(word_id, np.int32)
    word_weight = np.ascontiguousarray(word_weight, np.float32)
    return lib.orbvoc_dump(path.encode(), int(k), int(levels), node_desc.ctypes.data,
                           children.ctypes.data, int(children.shape[1]), word_id.ctypes.data,
                           word_weight.ctypes.data, int(len(node_desc))) == 0


# -------------------------------------------------------- image decode, prefetch


def imread_gray(path: str) -> Optional[np.ndarray]:
    """Native decode to (h, w) float32 grayscale; None without the library
    or for a file it declines (palette, interlaced, sub-byte depth, a
    corrupt header): the caller then takes the plain reader."""
    lib = get_lib()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.img_probe_file(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    if not (0 < w.value <= 65535 and 0 < h.value <= 65535 and w.value * h.value <= (1 << 28)):
        return None
    out = np.empty((h.value, w.value), np.float32)
    if lib.img_decode_file(path.encode(), out.ctypes.data, ctypes.byref(w), ctypes.byref(h),
                           out.size) != 0:
        return None
    return out


class PrefetchLoader:
    """Iterate the images of `paths` while a native worker thread decodes
    up to `capacity` frames ahead of the consumer. A frame the native
    decoder declines is read by `fallback(path)`."""

    def __init__(self, paths: List[str], fallback, capacity: int = 4):
        self.paths = list(paths)
        self._fallback = fallback
        self._i = 0
        self._handle = None
        lib = get_lib()
        if lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._handle = lib.loader_create(arr, len(self.paths), capacity)
            # receive buffer: twice the largest of the first frames' sizes
            mw = mh = 0
            w, h = ctypes.c_int(), ctypes.c_int()
            for p in self.paths[:8]:
                if lib.img_probe_file(p.encode(), ctypes.byref(w), ctypes.byref(h)) == 0:
                    mw, mh = max(mw, w.value), max(mh, h.value)
            self._buf = np.empty((max(mh, 1) * 2, max(mw, 1) * 2), np.float32)

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= len(self.paths):
            raise StopIteration
        path = self.paths[self._i]
        self._i += 1
        if self._handle is not None:
            w, h = ctypes.c_int(), ctypes.c_int()
            ret = get_lib().loader_next(self._handle, self._buf.ctypes.data, ctypes.byref(w),
                                        ctypes.byref(h), self._buf.size)
            if ret == 0:  # the native side writes one contiguous h * w block
                return self._buf.reshape(-1)[: h.value * w.value].reshape(h.value, w.value).copy()
            if ret == 1:
                raise StopIteration
        return self._fallback(path)

    def close(self):
        if self._handle is not None:
            get_lib().loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
