"""Captured programs: the port's counterpart of the JAX package's `jax.jit`.

The JAX package compiles its per-frame path into XLA programs, one per input
shape (`Tracking._ensure_frontend`, `build_fused_step`, the jitted
`pose_optimization`), and the mapper's device work too (the local-BA scan,
the vmapped triangulation, the essential graph). A `CapturedFunction` runs
the same PyTorch ops and hand-written kernels as a plain call of its
function, captured once per input key (the arguments' shapes, dtypes and
layouts) into a `torch.cuda.CUDAGraph`
and replayed after that: one graph launch in place of the thousands of
launches Python would issue.

Each call of a `CapturedFunction`:

- stages its arguments into the program's static input buffers: a tensor
  is copied in with `copy_` (from the host or the card) into a buffer of its
  own layout where that layout is dense (a transposed matrix stays
  transposed: an op may round differently on another layout, and the
  program must compute what the plain call computes), contiguous where it
  is not (a broadcast view); a `Fill` writes its
  buffer itself (`gathered`: a gather with `out=`, so that the tensor it
  gathers from is never part of a capture). Any other leaf of the argument
  tree raises `TypeError`: a Python number would be frozen into the capture;
- on the first call for a key, runs the function on the static buffers on
  its owner's side stream (which creates the cuBLAS handle and workspace and
  fills the allocator; its result is this call's result), then captures it
  on that stream while holding `lock` (the map lock for the tracker's
  programs: a mapper thread then runs no map stage) and then the process's
  capture lock, with `capture_error_mode="thread_local"`, so that the eager
  work other threads issue meanwhile is not refused, and with the cyclic
  garbage collector off (a collection on the capturing thread may destroy a
  dropped system's graph, which invalidates the capture);
- on later calls, replays the graph on its owner's stream;
- hands out clones of the outputs, since the next replay overwrites them.

Owners and their streams. The tracker's programs (the frontend, the unfused
pose solve, the batched step of `MultiStreamSLAM`) belong to the thread that
tracks, owner "tracker", and run on the device's default stream. Local
mapping's programs (the local-BA iterations) belong to the mapper thread,
and loop closing's (the essential graph's GN iteration, the global BA's LM
iterations) to the mapper thread and the `gba` thread, owner "mapper"; they
run on the mapper stream, one stream a device from torch's pool, which is
non-blocking: it never waits for the default stream unless told to, so a
host read of the mapper's results waits for the mapper's own work and not
for the frame the tracker has queued meanwhile. `owner_stream(device,
owner)` gives an owner's stream and `on_owner_stream` enters it; every
thread that does the mapper's device work enters the mapper stream, serially
the caller's thread too, so both modes run the same code on the same
streams. A call of a `CapturedFunction` off its owner's stream raises
`RuntimeError`, since the owner's shared memory pool below rests on it. A
tensor one stream wrote and the other reads is handed over explicitly
(`share_with`, `wait_for`: an event the reading stream waits on, and the
allocator told that the reading stream uses the tensor); the results of the
mapper come back to the host with `fetch`, one synchronisation of the
mapper stream a stage.

Each owner also has its own side stream, which joins the owner's stream
before and after a warm-up. Several threads may own "mapper" programs (a
threaded `MultiStreamSLAM` runs a mapper thread per stream, all on the one
mapper stream), so those warm up under the capture lock as well. One
capture runs at a time in the process: the caching allocator refuses to
empty its cache while a capture is under way, and captures do not wait for
the device. The lock order is `lock`, then the capture lock, on every
thread; a mapper program takes no `lock`, since local mapping runs its
device solves without the map lock. A capture may thus run on the mapper
thread while the caller's thread tracks: each thread synchronises the
stream it uses, never the whole device (`torch.cuda.synchronize()` from
another thread invalidates a capture in progress, and the capturing thread
then fails).

The programs of one owner share one memory pool in the process (one a
device, kept alive by a sentinel graph), across functions and systems, so
that it holds about one program's intermediates rather than the sum over
every function of every system (a threaded `MultiStreamSLAM` runs 8 mapper
threads). Two rules make the sharing safe. Every replay of an owner's
programs runs on that owner's one stream (checked at every call), so no two
programs of a pool ever run at once. A new capture reuses what the earlier
ones freed, so one program's static outputs may lie in another's
intermediates: a replay and the clone of its outputs are enqueued under one
process-wide lock, with no other thread's replay between them. A capture
that fails raises with the first error of the
first failed capture in the process (`capture_errors`): a failure can leave
the pool recording, and every later capture into it then fails with a
message of its own.
`max_programs` bounds how many programs one function keeps (the least
recently called goes first): local-BA windows change with every keyframe,
so their keys rarely repeat after the solve that made them.

A data-dependent exit (the JAX package's `lax.while_loop`) is captured with
`run_if(pred)`: while the current stream captures, the body of its `with`
block goes into a CUDA-graph IF node on `pred`, a 0-d bool tensor computed
on the capturing stream, so a replay runs the body only where `pred` is
true at that point of the replay. Outside a capture (a key's first call on
its owner's side stream, `graphs=False`, the CPU) the body simply runs. So
a body must give the same result whether it runs or not where `pred` is
false (a masked update, as `optim.pose_optimization`'s LM iterations are),
and must write the state that later code reads in place (`copy_`, `out=`):
a tensor a skipped body would have bound is never written. The node is made
by `csrc/graph_if.cu` (torch 2.11 binds no conditional node): a one-thread
kernel sets its condition from `pred` at every replay. Each owner's side
stream has a body stream, on which its bodies are captured, and a body pool
(a `torch.cuda.MemPool`) that their intermediates come from: one body's
intermediates are free again for the next, and, as with the owner's pool,
programs that replay one at a time on their owner's stream may share them.
`if_nodes` counts the nodes captured.

On the CPU the function runs on the static buffers at every call, without
capture: the same staging and the same clones. A capture or a replay that
fails raises; nothing falls back to running the function eagerly.

The hand-written kernels' wrappers count their launches
(`ops/orb/kernels.launch_counts`) only when Python calls them. The counts a
tracker capture adds are taken back (nothing ran) and added again at every
replay, so the counts stay one per kernel launch on the card. The mapper's
programs run no hand-written kernel (local mapping and loop closing extract
nothing), and their captures leave the counts alone, which the tracker's
replays move meanwhile.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels
from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build
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


@contextlib.contextmanager
def run_if(pred: torch.Tensor):
    """Run the `with` block's body only where the 0-d bool tensor `pred` is
    true: a CUDA-graph IF node while the current stream captures a
    `CapturedFunction`, the body unconditionally otherwise (see the module
    docstring). The node comes from `csrc/graph_if.cu` (torch 2.11 binds
    none); the body is captured on its capture stream's body stream, its
    allocations in that stream's body pool. Raises where no node can be
    made, rather than capture the body without its condition."""
    # a CPU build's capture query raises: never ask it for a CPU tensor
    if pred.device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        yield
        return
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"run_if: pred must be a 0-d bool tensor, got {pred.dtype} {tuple(pred.shape)}")
    parent = torch.cuda.current_stream(pred.device)
    body = _if_bodies.get(parent.cuda_stream)
    if body is None:
        raise RuntimeError("run_if: the capturing stream is no CapturedFunction's capture stream")
    stream, pool = body
    lib = cuda_build.load()
    _check_if(lib, lib.graph_if_begin(parent.cuda_stream, pred.data_ptr(), stream.cuda_stream))
    try:
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool, pred.device):
            yield
    finally:
        _check_if(lib, lib.graph_if_end(stream.cuda_stream))
    if_nodes[pred.device] = if_nodes.get(pred.device, 0) + 1


def _check_if(lib, rc: int):
    if rc != 0:
        raise RuntimeError(f"run_if: CUDA-graph IF node failed: {lib.graph_if_error(rc).decode()}")


# IF nodes captured by `run_if`, per device
if_nodes: dict = {}
# capture stream handle -> (its body stream, its body pool): see run_if
_if_bodies = {}
_side_streams = {}
_pools = {}
# (device index, owner) -> the stream of an owner whose work does not run
# on the default stream (the mapper's)
_owner_streams = {}
# the streams above are made once, by whichever thread asks first
_stream_lock = threading.Lock()
# the first error of every failed capture, in order (see the module docstring)
capture_errors: list = []

# one capture at a time in the process (see the module docstring)
_capture_lock = threading.Lock()
# a replay and the clone of its outputs, enqueued with no other replay
# between them (see the module docstring)
_replay_lock = threading.Lock()


def owner_stream(device, owner: str) -> Optional[torch.cuda.Stream]:
    """The stream `owner`'s device work runs on: for "mapper" one stream a
    device from torch's pool (non-blocking: no implicit wait for the default
    stream), made on first use and kept; the default stream for any other
    owner; None off CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if owner != "mapper":
        return torch.cuda.default_stream(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    s = _owner_streams.get((index, owner))
    if s is None:
        with _stream_lock:
            s = _owner_streams.get((index, owner))
            if s is None:
                s = _owner_streams[(index, owner)] = _new_stream(torch.device("cuda", index))
    return s


def on_owner_stream(device, owner: str):
    """A context that makes `owner_stream(device, owner)` the current stream
    (nothing off CUDA)."""
    s = owner_stream(device, owner)
    return contextlib.nullcontext() if s is None else torch.cuda.stream(s)


def stream_name(stream) -> str:
    """The name of a CUDA stream in reports: "default", an owner's name,
    or the handle of any other stream."""
    if stream == torch.cuda.default_stream(stream.device):
        return "default"
    for (_, owner), s in _owner_streams.items():
        if s == stream:
            return owner
    return hex(stream.cuda_stream)


def share_with(owner, tensors):
    """Hand CUDA tensors written on the current stream over to `owner`'s
    stream (or to the stream `owner`): the allocator keeps each one's memory
    until the work that stream has queued when it is freed is done
    (`record_stream`), and the returned event, recorded on the current
    stream behind the writes, is what a reader on that stream waits on
    (`wait_for`). None when no tensor is on CUDA."""
    tensors = [t for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"]
    if not tensors:
        return None
    dst = owner if isinstance(owner, torch.cuda.Stream) else owner_stream(tensors[0].device, owner)
    for t in tensors:
        t.record_stream(dst)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(tensors[0].device))
    return ready


def wait_for(ready) -> None:
    """Make the current stream wait for a `share_with` event (on the device
    only; nothing for None)."""
    if ready is not None:
        torch.cuda.current_stream().wait_event(ready)


def fetch(*tensors) -> tuple:
    """Numpy arrays of `tensors`, with the bits of `t.cpu().numpy()` each,
    each copied into a dense host tensor of its own: CUDA tensors with one
    non-blocking copy each into pinned host memory and one event on the
    current stream, waited for once, in place of one synchronisation a
    tensor; their arrays own their memory (the pinned buffers go back to
    the allocator). The event blocks (the thread sleeps until the copy is
    done, the GIL released): a thread that waits in `.cpu()` for a queued
    frame stalls every other thread's launches until the frame is done
    (`tools/stream_probe.py`)."""
    on_card = [t.device.type == "cuda" for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=c) for t, c in zip(tensors, on_card)]
    for h, t, c in zip(host, tensors, on_card):
        h.copy_(t, non_blocking=c)
    if any(on_card):
        done = torch.cuda.Event(blocking=True)
        done.record()
        done.synchronize()
    return tuple(h.numpy().copy() if c else h.numpy() for h, c in zip(host, on_card))


def _new_stream(device: torch.device) -> torch.cuda.Stream:
    """A stream from torch's pool that no owner, side or body stream of
    this module holds yet (the pool hands its streams out round robin)."""
    taken = ({s.cuda_stream for s in _owner_streams.values()}
             | {s.cuda_stream for s in _side_streams.values()}
             | {body.cuda_stream for body, _ in _if_bodies.values()})
    for _ in range(64):
        s = torch.cuda.Stream(device)
        if s.cuda_stream not in taken:
            return s
    raise RuntimeError("no CUDA stream of torch's pool is free for an owner")


def _owner_pool(device: torch.device, owner: str):
    """The memory pool `owner`'s programs of `device` capture into (call
    under the capture lock). A one-kernel sentinel graph is captured into it
    first and kept for the process's life: the caching allocators refuse a
    capture into a pool whose every graph was freed, as a system's are when
    it is dropped, and a `torch.cuda.MemPool` holds the device allocator's
    pool but not the pinned host allocator's."""
    entry = _pools.get((device, owner))
    if entry is None:
        pool, sentinel = torch.cuda.graph_pool_handle(), torch.cuda.CUDAGraph()
        with torch.cuda.stream(_capture_stream(device, owner)), _no_gc():
            sentinel.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                torch.zeros(1, device=device)
            finally:
                sentinel.capture_end()
        entry = _pools[(device, owner)] = (pool, sentinel)
    return entry[0]


@contextlib.contextmanager
def _no_gc():
    """The cyclic garbage collector off for the block: a collection on the
    capturing thread may free a dropped system's graphs, and destroying a
    graph there while this thread captures invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _capture_stream(device: torch.device, owner: str) -> torch.cuda.Stream:
    """The side stream on which `owner`'s programs of `device` warm up and
    capture (a cuBLAS workspace belongs to its stream)."""
    s = _side_streams.get((device, owner))
    if s is None:
        with _stream_lock:
            s = _side_streams.get((device, owner))
            if s is None:
                s = _side_streams[(device, owner)] = _new_stream(device)
                _if_bodies[s.cuda_stream] = (_new_stream(device), torch.cuda.MemPool())
    return s


def _segment_bytes(pool_id) -> int:
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool_id))


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def _staged_strides(a: torch.Tensor) -> tuple:
    """The strides of a's static buffer: a's own where they lay it out
    densely (a permutation of the contiguous layout: a transposed view,
    say), else contiguous (a broadcast, a strided slice). The stride of a
    dimension of size 1 is no part of a layout: it is the contiguous one,
    so that `x[None]` of numpy (stride 0) and `torch.zeros` (stride n) key
    one program."""
    contiguous = _contiguous_strides(a.shape)
    expected = 1
    for d in sorted(range(a.dim()), key=lambda d: (a.stride(d), a.shape[d])):
        if a.shape[d] != 1 and a.stride(d) != expected:
            return contiguous
        expected *= a.shape[d]
    return tuple(c if n == 1 else st for n, st, c in zip(a.shape, a.stride(), contiguous))


class Program:
    """One captured program: the static input buffers of its layout key, its
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

class CapturedFunction:
    """`fn` captured once per input key and replayed (see the module
    docstring). `fn` takes and returns trees (tuples, named tuples) of
    tensors. `lock` is a context manager factory held around each capture;
    `owner` names the thread that calls it ("tracker" or "mapper"), whose
    side stream it captures on; `max_programs` bounds the programs it keeps.
    One thread calls a CapturedFunction at a time."""

    def __init__(self, fn: Callable, device, name: str = "",
                 lock: Optional[Callable[[], contextlib.AbstractContextManager]] = None,
                 owner: str = "tracker", max_programs: Optional[int] = None):
        self.fn = fn
        self.device = resolve_device(device)
        self.name = name or getattr(fn, "__name__", "program")
        self.lock = lock or contextlib.nullcontext
        self.owner = owner
        self.max_programs = max_programs
        self.programs = {}  # key -> Program, least recently called first
        self.last_inputs = None  # the static argument tree of the last call
        self.n_captures = self.n_replays = self.n_evicted = 0

    # ---------------------------------------------------------------- staging

    def _key(self, args):
        leaves, spec = pytree.tree_flatten(args)
        shapes = []
        for i, a in enumerate(leaves):
            if isinstance(a, torch.Tensor):
                shapes.append((tuple(a.shape), a.dtype, _staged_strides(a)))
            elif isinstance(a, Fill):
                shapes.append((a.shape, a.dtype, _contiguous_strides(a.shape)))
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

    def _program(self, key):
        """The program of `key` (made, and the oldest dropped past
        `max_programs`, when new), moved to the most recent end."""
        prog = self.programs.pop(key, None)
        if prog is None:
            if self.max_programs is not None and len(self.programs) >= self.max_programs:
                # not during another thread's capture into the same pool
                with _capture_lock:
                    if self.device.type == "cuda":  # a dropped graph may still run
                        torch.cuda.current_stream(self.device).synchronize()
                    del self.programs[next(iter(self.programs))]
                self.n_evicted += 1
            prog = Program(key, [torch.empty_strided(s, st, dtype=dt, device=self.device)
                                 for s, dt, st in key[1]])
        self.programs[key] = prog
        return prog

    # ------------------------------------------------------------------- call

    def __call__(self, *args):
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if stream != owner_stream(self.device, self.owner):
                raise RuntimeError(f"{self.name}: called on the {stream_name(stream)} stream, not on "
                                   f"owner {self.owner!r}'s stream, which its shared memory pool requires")
        key, leaves, spec = self._key(args)
        prog = self._program(key)
        new = prog.n_calls == 0
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
            with _replay_lock:
                prog.graph.replay()
                out = pytree.tree_map_only(torch.Tensor, torch.clone, prog.outputs)
            prog.n_replays += 1
            self.n_replays += 1
            for name, n in prog.launches.items():
                kernels.launch_counts[name] += n
            return out
        return pytree.tree_map_only(torch.Tensor, torch.clone, out)

    def _warm_up_and_capture(self, prog: Program, static_args):
        """The first call of a key: fn on the static buffers on the side
        stream (the call's result), then its capture on that stream."""
        if self.owner == "tracker":  # one thread: warm up without the locks
            out = self._warm_up(static_args)
            with self.lock(), _capture_lock:
                self._capture(prog, static_args)
        else:  # its owner's side stream may serve several threads
            with self.lock(), _capture_lock:
                out = self._warm_up(static_args)
                self._capture(prog, static_args)
        return out

    def _warm_up(self, static_args):
        current = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device, self.owner)
        side.wait_stream(current)
        with torch.no_grad(), torch.cuda.stream(side):
            out = self.fn(*static_args)
        current.wait_stream(side)
        # the caller reads the outputs on its stream: their memory must not
        # go back to the side stream, which another mapper thread's warm-up
        # may write next, before that read
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(current)
        return out

    def _capture(self, prog: Program, static_args):
        """Capture fn into the program's graph in its owner's pool (the
        `torch.cuda.graph` context without its device synchronisation and
        cache emptying, which another thread's work must not wait for)."""
        graph = torch.cuda.CUDAGraph()
        counted = dict(kernels.launch_counts)
        try:
            pool = _owner_pool(self.device, self.owner)
            with torch.no_grad(), torch.cuda.stream(_capture_stream(self.device, self.owner)), _no_gc():
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    prog.outputs = self.fn(*static_args)
                finally:
                    graph.capture_end()
        except Exception as e:
            first = e
            while first.__context__ is not None:  # what failed first inside this capture
                first = first.__context__
            capture_errors.append(f"{self.name} (owner {self.owner}): {type(first).__name__}: "
                                  + (str(first).splitlines() or [""])[0])
            raise RuntimeError(f"capture of {self.name} failed; the first failed capture in this "
                               f"process: {capture_errors[0]}") from e
        if self.owner == "tracker":
            # the capture launched nothing: its counts move to every replay
            prog.launches = {name: kernels.launch_counts[name] - n for name, n in counted.items()
                             if kernels.launch_counts[name] != n}
            for name, n in prog.launches.items():
                kernels.launch_counts[name] -= n
        prog.graph = graph
        prog.n_captures += 1
        self.n_captures += 1

    # ---------------------------------------------------------------- reports

    def pool_bytes(self) -> int:
        """Bytes of the memory pool its owner's programs share on the card
        (their intermediates and static outputs); 0 on the CPU or before a
        capture."""
        entry = _pools.get((self.device, self.owner))
        return 0 if entry is None else _segment_bytes(entry[0])

    def body_pool_bytes(self) -> int:
        """Bytes of its owner's body pool (`run_if`'s IF-node bodies); 0 on
        the CPU or before a capture."""
        stream = _side_streams.get((self.device, self.owner))
        return 0 if stream is None else _segment_bytes(_if_bodies[stream.cuda_stream][1].id)

    def report(self) -> list:
        """One dict per program kept: its key's leaf shapes, captures,
        replays, calls, the MB of its static inputs, of the pool it shares
        with its owner's other programs and of their body pool."""
        pool_mb, body_mb = self.pool_bytes() / 1e6, self.body_pool_bytes() / 1e6
        return [{"name": self.name, "shapes": [list(s) for s, *_ in p.key[1]],
                 "captures": p.n_captures, "replays": p.n_replays, "calls": p.n_calls,
                 "input_mb": p.input_bytes() / 1e6, "pool_mb": pool_mb, "body_pool_mb": body_mb}
                for p in self.programs.values()]

    def summary(self) -> dict:
        """Captures and replays over the function's life (dropped programs
        included), the programs kept and dropped, and its owner's pool and
        body pool MB. Every replay ran on the owner's stream (a call off it
        raises)."""
        return {"name": self.name, "captures": self.n_captures, "replays": self.n_replays,
                "kept": len(self.programs), "dropped": self.n_evicted,
                "pool_mb": self.pool_bytes() / 1e6, "body_pool_mb": self.body_pool_bytes() / 1e6}
