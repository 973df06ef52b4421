"""Device meshes over `torch.distributed` ranks, and local rank groups.

The JAX package builds a `jax.sharding.Mesh` inline and runs one program
over it (`shard_map`, single controller). Here every mesh device is a
process (a rank), and a sharded function runs on every rank with the
same arguments: it takes `(mesh, axis)` as the JAX function does and
collects over `mesh.get_group(axis)` with explicit collectives. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named axes
(`make_mesh(device, (2, 2), ("dp", "mp"))`).

The collectives are `all_reduce` (SUM, and MIN for the argmin combine of
the sharded step) and `all_gather` (`gather_blocks`). Both transports take
them for CPU and CUDA tensors, so there is one code path: gloo (CPU ranks,
or several ranks on one card, the collectives' bytes through host memory)
and NCCL (one rank per card).

`spawn` starts N local ranks and runs one function on each: the process
group through a `file://` store in a temporary directory, a finite
collective timeout, every rank joined with a time limit, the first rank's
exception re-raised in the caller with its traceback, and every rank still
alive at the end killed, so a rank that fails never leaves the others
waiting in a collective.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
import uuid

import torch
import torch.distributed as dist


class RankError(RuntimeError):
    """A rank of `spawn` failed; the message holds its traceback."""


def make_mesh(device, shape: tuple, names: tuple):
    """A DeviceMesh over all ranks of the process group, with named axes,
    for tensors on `device` (a CPU or CUDA torch.device)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=tuple(names))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of `mesh` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the named axis (the JAX mesh's shape[axis])."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def block(x, mesh, axis: str, dim: int = 0):
    """This rank's contiguous block of x along `dim`, the axis split evenly
    over `mesh[axis]` in coordinate order (a view)."""
    n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis length {size} not divisible by mesh axis {axis!r} of size {n}")
    return x.narrow(dim, i * (size // n), size // n)


def gather_blocks(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The inverse of `block`: every rank's block of `mesh[axis]` along `dim`,
    concatenated in coordinate order, on every rank (one all_gather; bool
    blocks travel as int32)."""
    src = (x.to(torch.int32) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=mesh.get_group(axis))
    out = torch.cat(parts, dim)
    return out.bool() if x.dtype == torch.bool else out


def to_host(obj):
    """obj with every tensor moved to a numpy array (NamedTuples, tuples,
    lists and dicts kept), so that it pickles across processes."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_host(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def run_calls(device, calls):
    """A rank target of `spawn`: each call `(fn, mesh_shape, mesh_names, args,
    kwargs)` as fn(mesh, *args, **kwargs) on a mesh of that shape (one mesh
    per shape, built in call order on every rank). Returns, per call, the
    result through `to_host` and its seconds on this rank (host clock around
    the call, which ends in a device synchronisation)."""
    meshes, out = {}, []
    for fn, shape, names, args, kwargs in calls:
        key = (tuple(shape), tuple(names))
        if key not in meshes:
            meshes[key] = make_mesh(device, shape, names)
        synchronize(device)
        t0 = time.perf_counter()
        res = fn(meshes[key], *args, **kwargs)
        synchronize(device)
        out.append((to_host(res), time.perf_counter() - t0))
    return out


def fail_on_rank(mesh, axis: str, rank: int):
    """Rank `rank` of `mesh[axis]` raises while the others wait in an
    all_reduce that cannot complete without it: the failure `spawn` must
    turn into an exception in its caller, killing the waiting ranks."""
    if mesh.get_local_rank(axis) == rank:
        raise ValueError(f"rank {rank} of {axis!r} fails on purpose")
    dist.all_reduce(torch.ones(1, device=mesh_device(mesh)), group=mesh.get_group(axis))


def synchronize(device):
    """Wait for the work queued on `device` (a no-op off CUDA)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _rank_main(rank, n_ranks, backend, device_type, store, timeout_s, num_threads,
               results, target, args):
    ok, payload, tb = False, None, None
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        # every rank is on this host: gloo and NCCL's bootstrap over loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device(device_type)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=n_ranks,
                                timeout=datetime.timedelta(seconds=timeout_s))
        payload, ok = target(device, *args), True
    except BaseException as exc:  # reported to the caller, which re-raises it
        tb = traceback.format_exc()
        try:
            payload = pickle.loads(pickle.dumps(exc))
        except Exception:
            payload = None
    results.put((rank, ok, payload, tb))
    if ok and dist.is_initialized():
        dist.destroy_process_group()


def spawn(target, n_ranks: int, *, backend: str, device: str, args: tuple = (),
          timeout_s: float = 300.0, store_dir=None, num_threads=None) -> list:
    """Run target(rank_device, *args) on `n_ranks` new local processes that
    form one process group, and return their results in rank order.

    `backend` is "gloo" or "nccl"; `device` "cpu" or "cuda" (rank r then
    uses card r % device_count, so four gloo ranks share one card). Ranks
    are started with the `spawn` method (the caller may hold a CUDA
    context), meet through a `file://` store in `store_dir` (a new
    temporary directory by default), and run their collectives with a
    `timeout_s` limit. The call waits at most `timeout_s` for all results.
    The first failure (an exception, a rank that exits without a result, or
    the time limit) is raised here, the rank's own exception chained to a
    RankError with its traceback; every rank still alive is killed before
    this returns or raises. `num_threads` sets each rank's CPU threads."""
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="slam_ranks_") if own_dir else str(store_dir)
    store = os.path.join(store_dir, f"store_{uuid.uuid4().hex}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, n_ranks, backend, device, store, timeout_s, num_threads,
                               results, target, args))
             for rank in range(n_ranks)]
    done = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(done) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in range(n_ranks) if r not in done]
                raise RankError(f"ranks {missing} did not finish within {timeout_s} s")
            try:
                rank, ok, payload, tb = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if dead:  # a rank that exits flushes its result first: one more look
                    try:
                        rank, ok, payload, tb = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RankError(f"rank {dead[0]} exited with code "
                                        f"{procs[dead[0]].exitcode} without a result") from None
                else:
                    continue
            if not ok:
                err = RankError(f"rank {rank} of {n_ranks} failed:\n{tb}")
                if isinstance(payload, BaseException):
                    raise payload from err
                raise err
            done[rank] = payload
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=30)
        results.close()
        results.cancel_join_thread()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [done[r] for r in range(n_ranks)]
