"""Collectives over the 'model' axis, and the launcher of rank processes.

The reference's sharded paths call ``jax.lax`` collectives inside a
``shard_map``; here each rank is a process and these call
``torch.distributed`` on the mesh's 'model' group:

``psum(x, mesh)``        sum over the ranks (all-reduce)
``all_gather(x, mesh)``  ``[P, *x.shape]``, rank j's ``x`` at index j
``all_to_all(x, mesh)``  ``x [P, ...]``: index j goes to rank j; the result
                         holds at index j what rank j sent here
``ppermute(x, mesh)``    the ring shift: send to rank+1, receive from rank-1

Gloo runs on host memory.  When the group's backend is gloo and a tensor
lies on the card, the tensor is copied to the host, the collective runs
there and the result is copied back.  That staging is explicit and counted
on the mesh (``Mesh.staged``, ``Mesh.staged_bytes``, ``Mesh.staged_s``):
its times are not NVLink's.  The data movement is exact, so results are bit-identical to an
unstaged run.

``run_ranks(fn, world, *args)`` starts ``world`` rank processes with the
``spawn`` start method (a parent that has initialised CUDA cannot fork),
joins them through a ``FileStore`` in a temporary directory (no network
discovery), calls ``fn(mesh, *args)`` in each and returns the ranks'
results.  Gloo can put several ranks on one device; NCCL cannot, and asking
for it raises.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.dist.context import Mesh


def _backend(mesh: Mesh) -> str:
    return dist.get_backend(mesh.group)


def _to_host(x: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, bool]:
    """(``x`` as the collective takes it: contiguous, and copied to the
    host when gloo must carry a CUDA tensor; whether it was)."""
    x = x.contiguous()
    if x.is_cuda and _backend(mesh) == "gloo":
        return x.cpu(), True
    return x, False


def _back(out: torch.Tensor, x: torch.Tensor, mesh: Mesh, name: str,
          staged: bool, t0: float) -> torch.Tensor:
    """``out`` on ``x``'s device; a staged call is counted on the mesh
    (calls, payload bytes, host-clock seconds from ``t0``, the copies
    included)."""
    if not staged:
        return out
    out = out.to(x.device)
    mesh.staged[name] += 1
    mesh.staged_bytes += x.numel() * x.element_size()
    mesh.staged_s[name] += time.perf_counter() - t0
    return out


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the 'model' ranks (a new tensor)."""
    if mesh.model == 1:
        return x.clone()
    t0 = time.perf_counter()
    buf, staged = _to_host(x, mesh)
    if not staged:
        buf = buf.clone()               # all_reduce works in place
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return _back(buf, x, mesh, "psum", staged, t0)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """-> ``[P, *x.shape]``, rank j's ``x`` at index j."""
    if mesh.model == 1:
        return x[None].clone()
    t0 = time.perf_counter()
    buf, staged = _to_host(x, mesh)
    out = torch.empty(mesh.model * buf.numel(), dtype=x.dtype,
                      device=buf.device)
    dist.all_gather_into_tensor(out, buf.reshape(-1), group=mesh.group)
    out = out.reshape((mesh.model,) + tuple(x.shape))
    return _back(out, x, mesh, "all_gather", staged, t0)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x [P, ...]`` -> ``[P, ...]``: ``x[j]`` goes to rank j, and index j
    of the result is what rank j sent to this rank."""
    if x.shape[0] != mesh.model:
        raise ValueError(f"all_to_all needs a leading axis of {mesh.model}, "
                         f"got {tuple(x.shape)}")
    if mesh.model == 1:
        return x.clone()
    t0 = time.perf_counter()
    buf, staged = _to_host(x, mesh)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group)
    return _back(out, x, mesh, "all_to_all", staged, t0)


def ppermute(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ring shift: this rank's ``x`` goes to rank+1, and the result is
    rank-1's (group ranks, mapped to global ranks for the point-to-point
    calls)."""
    if mesh.model == 1:
        return x.clone()
    t0 = time.perf_counter()
    buf, staged = _to_host(x, mesh)
    out = torch.empty_like(buf)
    group = mesh.group if mesh.group is not None else dist.group.WORLD
    nxt = dist.get_global_rank(group, (mesh.rank + 1) % mesh.model)
    prv = dist.get_global_rank(group, (mesh.rank - 1) % mesh.model)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, nxt, group),
        dist.P2POp(dist.irecv, out, prv, group)])
    for r in reqs:
        r.wait()
    return _back(out, x, mesh, "ppermute", staged, t0)


# ------------------------------------------------------------ rank processes

def _rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _check_backend(backend: str, world: int, device: str) -> None:
    """NCCL needs a device of its own for every rank."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if backend != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("nccl runs on CUDA devices only")
    if world > 1 and dev.index is not None:
        raise ValueError(
            f"nccl cannot put {world} ranks on the one device {dev}: give "
            "each rank its own card (device='cuda') or use gloo, which "
            "stages its collectives through host memory")
    if world > torch.cuda.device_count():
        raise ValueError(
            f"nccl needs one card per rank: {world} ranks, "
            f"{torch.cuda.device_count()} cards; gloo can share a card")


def _rank_main(rank: int, fn, world: int, backend: str, device: str,
               tmp: str, timeout_s: float, args: tuple) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = Mesh(model=world, rank=rank, device=dev,
                    group=dist.group.WORLD)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str = "gloo",
              device: str = "cpu", timeout_s: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` rank processes of one
    ``(data=1, model=world)`` mesh; -> the ranks' return values, by rank.

    ``fn`` must be importable by name (a module-level function: ``spawn``
    pickles it by reference) and return host data (tensors on the CPU,
    numbers, numpy arrays), which ``torch.save`` carries back.  ``device``
    is every rank's device ("cpu", or one card for all ranks, "cuda:0";
    with nccl, "cuda" gives rank r the card r).  A rank that raises ends
    the others, and ``run_ranks`` raises."""
    import torch.multiprocessing as mp

    _check_backend(backend, world, device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, backend, device, tmp, timeout_s,
                                 args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
