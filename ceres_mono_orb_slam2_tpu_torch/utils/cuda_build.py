"""Build and load the hand-written CUDA kernels in `csrc/` (and the host
half of `utils/graphs.run_if`'s CUDA-graph IF nodes, `csrc/graph_if.cu`).

The kernels have a plain C interface and are bound with ctypes: at first
use, one `nvcc` per `csrc/*.cu` file, all started together, compiles it for
`sm_90a` (Hopper), and the objects are linked into one shared library keyed
by a hash of the sources and flags, in `.kernels_build/` at the root of the
checkout (listed in `.gitignore`). Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".kernels_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = 0.0  # wall time of this process's build (0 when cached)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed shared library unless it exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    t0 = time.perf_counter()
    objs = [Path(f"{stem}.{src.stem}.o") for src in sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = Path(f"{stem}.tmp.so")
    ok = all(p.returncode == 0 for p in procs)
    if ok:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        ok = link.returncode == 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if not ok:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The loaded kernel library, building it on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fast_nms_launch.argtypes = [vp, vp, ci, cl, vp, ci, ci, vp]
        lib.fast_nms_launch.restype = ci
        lib.gather_patches_launch.argtypes = [vp, vp, ci, ci, vp, vp, ci, ci, ci, vp, vp, ci, ci,
                                              cl, vp, vp, ci, vp]
        lib.gather_patches_launch.restype = ci
        lib.graph_if_begin.argtypes = [vp, vp, vp]
        lib.graph_if_begin.restype = ci
        lib.graph_if_end.argtypes = [vp]
        lib.graph_if_end.restype = ci
        lib.graph_if_error.argtypes = [ci]
        lib.graph_if_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib
