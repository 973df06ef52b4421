"""Captured programs: the port's counterpart of the JAX package's `jax.jit`.

The JAX package compiles its per-frame path into XLA programs, one per input
shape (`Tracking._ensure_frontend`, `build_fused_step`, the jitted
`pose_optimization`). A `CapturedFunction` runs the same PyTorch ops and
hand-written kernels as a plain call of its function, captured once per
input-shape key into a `torch.cuda.CUDAGraph` and replayed after that: one
graph launch in place of the thousands of launches Python would issue.

Each call of a `CapturedFunction`:

- stages its arguments into the program's static input buffers: a tensor
  is copied in with `copy_` (from the host or the card); a `Fill` writes its
  buffer itself (`gathered`: a gather with `out=`, so that the tensor it
  gathers from is never part of a capture). Any other leaf of the argument
  tree raises `TypeError`: a Python number would be frozen into the capture;
- on the first call for a key, runs the function on the static buffers on a
  side stream (which creates the cuBLAS handle and workspace and fills the
  allocator; its result is this call's result), then captures it on that
  stream while holding `lock` (the map lock: a mapper thread then runs no
  map stage), with `capture_error_mode="thread_local"`, so that the eager
  work other threads issue meanwhile is not refused;
- on later calls, replays the graph on the current stream;
- hands out clones of the outputs, since the next replay overwrites them.

On the CPU the function runs on the static buffers at every call, without
capture: the same staging and the same clones. A capture or a replay that
fails raises; nothing falls back to running the function eagerly.

The hand-written kernels' wrappers count their launches
(`ops/orb/kernels.launch_counts`) only when Python calls them. The counts a
capture adds are taken back (nothing ran) and added again at every replay,
so the counts stay one per kernel launch on the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels
from ceres_mono_orb_slam2_tpu_torch.utils.device import resolve_device


class Fill:
    """An argument that writes the program's static buffer itself:
    `fill(dst)` with dst the (shape, dtype) buffer on the program's device."""

    __slots__ = ("shape", "dtype", "fill")

    def __init__(self, shape, dtype: torch.dtype, fill: Callable[[torch.Tensor], object]):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.fill = fill


def gathered(src: torch.Tensor, index: torch.Tensor) -> Fill:
    """Rows `index` (a 1-d int64 tensor on src's device) of `src`, gathered
    with `index_select` straight into the static buffer."""
    return Fill((index.shape[0],) + tuple(src.shape[1:]), src.dtype,
                lambda dst: torch.index_select(src, 0, index, out=dst))


def stacked(tensors) -> Fill:
    """torch.stack(tensors) written straight into the static buffer."""
    tensors = list(tensors)
    return Fill((len(tensors),) + tuple(tensors[0].shape), tensors[0].dtype,
                lambda dst: torch.stack(tensors, out=dst))


_side_streams = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which programs of `device` warm up and capture
    (one per device: a cuBLAS workspace belongs to its stream)."""
    s = _side_streams.get(device)
    if s is None:
        s = _side_streams[device] = torch.cuda.Stream(device)
    return s


class Program:
    """One captured program: the static input buffers of its shape key, its
    static outputs and graph (None on the CPU), the kernel launches one
    replay makes, and how often it was captured and replayed."""

    def __init__(self, key, inputs: list):
        self.key = key
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches = {}
        self.n_captures = 0
        self.n_replays = 0
        self.n_calls = 0

    def input_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.inputs)

    def pool_bytes(self) -> int:
        """Bytes of the graph's private memory pool (its intermediates and
        static outputs) on the card; 0 on the CPU."""
        if self.graph is None:
            return 0
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class CapturedFunction:
    """`fn` captured once per input-shape key and replayed (see the module
    docstring). `fn` takes and returns trees (tuples, named tuples) of
    tensors. `lock` is a context manager factory held around each capture.
    One thread calls a CapturedFunction at a time."""

    def __init__(self, fn: Callable, device, name: str = "",
                 lock: Optional[Callable[[], contextlib.AbstractContextManager]] = None):
        self.fn = fn
        self.device = resolve_device(device)
        self.name = name or getattr(fn, "__name__", "program")
        self.lock = lock or contextlib.nullcontext
        self.programs = {}
        self.last_inputs = None  # the static argument tree of the last call

    # ---------------------------------------------------------------- staging

    def _key(self, args):
        leaves, spec = pytree.tree_flatten(args)
        shapes = []
        for i, a in enumerate(leaves):
            if isinstance(a, torch.Tensor):
                shapes.append((tuple(a.shape), a.dtype))
            elif isinstance(a, Fill):
                shapes.append((a.shape, a.dtype))
            else:
                raise TypeError(f"{self.name}: argument leaf {i} is a {type(a).__name__}, not a tensor: "
                                "a value that is not a tensor would be frozen into the capture")
        return (spec, tuple(shapes)), leaves, spec

    def _stage(self, prog: Program, leaves):
        for dst, a in zip(prog.inputs, leaves):
            if isinstance(a, Fill):
                a.fill(dst)
            else:
                dst.copy_(a)

    # ------------------------------------------------------------------- call

    def __call__(self, *args):
        key, leaves, spec = self._key(args)
        prog = self.programs.get(key)
        new = prog is None
        if new:
            prog = Program(key, [torch.empty(s, dtype=dt, device=self.device) for s, dt in key[1]])
            self.programs[key] = prog
        self._stage(prog, leaves)
        static_args = self.last_inputs = pytree.tree_unflatten(prog.inputs, spec)
        prog.n_calls += 1
        if self.device.type != "cuda":
            with torch.no_grad():
                out = self.fn(*static_args)
        elif new:
            try:
                out = self._warm_up_and_capture(prog, static_args)
            except BaseException:
                del self.programs[key]
                raise
        else:
            prog.graph.replay()
            prog.n_replays += 1
            for name, n in prog.launches.items():
                kernels.launch_counts[name] += n
            out = prog.outputs
        return pytree.tree_map_only(torch.Tensor, torch.clone, out)

    def _warm_up_and_capture(self, prog: Program, static_args):
        """The first call of a key: fn on the static buffers on the side
        stream (the call's result), then its capture on that stream."""
        current = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(current)
        with torch.no_grad(), torch.cuda.stream(side):
            out = self.fn(*static_args)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        counted = dict(kernels.launch_counts)
        with self.lock(), torch.no_grad():
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                prog.outputs = self.fn(*static_args)
        # the capture launched nothing: its counts move to every replay
        prog.launches = {name: kernels.launch_counts[name] - n for name, n in counted.items()
                         if kernels.launch_counts[name] != n}
        for name, n in prog.launches.items():
            kernels.launch_counts[name] -= n
        prog.graph = graph
        prog.n_captures += 1
        return out

    # ---------------------------------------------------------------- reports

    def report(self) -> list:
        """One dict per program: its key's leaf shapes, captures, replays,
        calls, and the MB of its static inputs and of its private pool."""
        return [{"name": self.name, "shapes": [list(s) for s, _ in p.key[1]],
                 "captures": p.n_captures, "replays": p.n_replays, "calls": p.n_calls,
                 "input_mb": p.input_bytes() / 1e6, "pool_mb": p.pool_bytes() / 1e6}
                for p in self.programs.values()]
