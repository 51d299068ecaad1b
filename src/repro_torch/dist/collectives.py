"""Collectives over a mesh axis, and the launcher of rank processes.

The reference's sharded paths call ``jax.lax`` collectives inside a
``shard_map``; here each rank is a process and these call
``torch.distributed`` on the group of the axis named (``axis``: 'model',
the default, 'data' or 'world'):

``psum(x, mesh)``        sum over the axis's ranks (all-reduce)
``fold_sum(x, mesh)``    the same sum taken in rank order on every rank
                         (an all-gather, then a left fold): every replica
                         gets the same bits
``all_gather(x, mesh)``  ``[n, *x.shape]``, the axis's rank j's ``x`` at j
``all_to_all(x, mesh)``  ``x [P, ...]``: index j goes to 'model' rank j; the
                         result holds at index j what rank j sent here
``ppermute(x, mesh)``    the 'model' ring shift: send to rank+1, receive
                         from rank-1
``world_max(x, mesh)``   the elementwise max over every rank of the mesh
``pmax(x, mesh)``        the elementwise max over the axis's ranks
``psum_scatter(x, mesh)`` the 'model' sum of ``x`` [P * c, ...], rank j
                         keeping rows ``[j * c, (j + 1) * c)``
``gather_rows(x, mesh)`` the 'model' slabs concatenated on world rank 0
``gather_tiled(x, mesh, axis, dim, name)`` the all-gather's parts
                         concatenated along ``dim``

``axis`` may also be a tuple of mesh axes, as the reference's collectives
take them: ``("model",)``, ``("data",)``, or ``("data", "model")``, which
is the 'world' group.

Those carry no gradient.  The training step under a mesh differentiates
through four that do, each the transpose of the other's direction (the
pairs the reference's ``shard_map`` transposes emit):

``gather_t(x, mesh, axis, dim)``   all-gather tiled along ``dim``; its
                         backward sums the cotangent over the axis and
                         keeps this rank's block (a reduce-scatter)
``scatter_t(x, mesh, axis, dim)``  that reduce-scatter; its backward is the
                         all-gather
``enter_model(x, mesh)`` the identity, whose backward sums over 'model'
                         (a replicated activation entering a column-parallel
                         matmul: Megatron's f)
``leave_model(x, mesh)`` the sum over 'model', whose backward is the
                         identity (a row-parallel matmul's partial sums:
                         Megatron's g)

Their staged calls are counted under their own names: ``ag_fwd`` /
``ag_bwd`` (the gather and its reduce-scatter), ``rs_fwd`` / ``rs_bwd``,
``enter_bwd`` and ``leave_fwd``.

Gloo runs on host memory.  When the group's backend is gloo and a tensor
lies on the card, the tensor is copied to the host, the collective runs
there and the result is copied back.  Where every rank lies on one card
(``Mesh.one_card``, gloo ranks sharing a GPU), ``all_gather`` of a CUDA
tensor of IPC_MIN_BYTES or more moves no bytes through the host: each rank
names its staging buffer (a CUDA IPC handle) in the process group's store
and copies the others' device to device (``_ipc_all_gather``; counted in
``Mesh.ipc_calls``).  Smaller tensors take gloo, whose one collective
costs less than the IPC path's handshake and two barriers
(``chip_smoke.py``'s phase 39 times both transports on each side of the
cutoff).  Reductions stay on gloo: through IPC each would hold a staging
buffer of its size on the card beside the rank's state, which four ranks
of the sharded recsys model can not spare.  The host staging is explicit
and counted on the mesh by collective and by axis (``Mesh.staged``,
``staged_bytes``, ``staged_s``, ``axis_bytes``, ``axis_s``): its times
are not NVLink's.  The data movement is exact, so results are
bit-identical to an unstaged run.

``run_ranks(fn, world, *args, data=D)`` starts ``world`` rank processes
with the ``spawn`` start method (a parent that has initialised CUDA cannot
fork), joins them through a ``FileStore`` in a temporary directory (no
network discovery), builds the ``(data=D, model=world/D)`` mesh's groups,
calls ``fn(mesh, *args)`` in each and returns the ranks' results.  Gloo can
put several ranks on one device; NCCL cannot, and asking for it raises.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.dist.context import Mesh


def axis_name(axis) -> str:
    """A mesh axis or a tuple of mesh axes -> the name of its group."""
    if isinstance(axis, str):
        return axis
    axes = tuple(axis)
    if axes in (("model",), ("data",)):
        return axes[0]
    if axes == ("data", "model"):
        return "world"
    raise ValueError(f"no process group for the mesh axes {axes}")


def _axis(mesh: Mesh, axis) -> tuple[int, int, object]:
    """(size, this rank's index, process group) of a mesh axis."""
    axis = axis_name(axis)
    if axis == "model":
        return mesh.model, mesh.rank, mesh.group
    if axis == "data":
        return mesh.data, mesh.data_rank, mesh.data_group
    if axis == "world":
        return mesh.world, mesh.world_rank, None
    raise ValueError(f"unknown mesh axis {axis!r}")


def _backend(group) -> str:
    return dist.get_backend(group)


def _to_host(x: torch.Tensor, group) -> tuple[torch.Tensor, bool]:
    """(``x`` as the collective takes it: contiguous, and copied to the
    host when gloo must carry a CUDA tensor; whether it was)."""
    x = x.contiguous()
    if x.is_cuda and _backend(group) == "gloo":
        return x.cpu(), True
    return x, False


def _back(out: torch.Tensor, x: torch.Tensor, mesh: Mesh, name: str,
          staged: bool, t0: float, axis: str = "model") -> torch.Tensor:
    """``out`` on ``x``'s device; a staged call is counted on the mesh
    (calls, payload bytes, host-clock seconds from ``t0``, the copies
    included), under its axis."""
    if not staged:
        return out
    out = out.to(x.device)
    _count(mesh, name, axis, x.numel() * x.element_size(), t0)
    return out


def _count(mesh: Mesh, name: str, axis: str, nbytes: int, t0: float):
    key = name if axis == "model" else f"{name}/{axis}"
    dt = time.perf_counter() - t0
    mesh.staged[key] += 1
    mesh.staged_bytes += nbytes
    mesh.staged_s[key] += dt
    mesh.axis_bytes[axis] += nbytes
    mesh.axis_s[axis] += dt


IPC_MIN_BYTES = 1 << 20


def _ipc(x: torch.Tensor, mesh: Mesh) -> bool:
    """Does this all_gather go through CUDA IPC (``Mesh.one_card``)?"""
    return (x.is_cuda and mesh.one_card
            and x.numel() * x.element_size() >= IPC_MIN_BYTES)


def _reduce(x: torch.Tensor, mesh: Mesh, axis, op, name: str):
    n, _, group = _axis(mesh, axis)
    if n == 1:
        return x.clone()
    t0 = time.perf_counter()
    buf, staged = _to_host(x, group)
    if not staged:
        buf = buf.clone()               # all_reduce works in place
    dist.all_reduce(buf, op=op, group=group)
    return _back(buf, x, mesh, name, staged, t0, axis_name(axis))


def psum(x: torch.Tensor, mesh: Mesh, axis="model") -> torch.Tensor:
    """Sum of ``x`` over the axis's ranks (a new tensor)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM, "psum")


def psum_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The 'model' sum of ``x`` [P * c, ...], tiled on dim 0: this rank
    keeps rows ``[rank * c, (rank + 1) * c)`` of it.  Gloo has no
    reduce-scatter: it runs as an all-reduce whose other rows are dropped
    (the same sums; counted as one ``psum_scatter``)."""
    P = mesh.model
    if x.shape[0] % P:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows over a 'model' "
                         f"axis of {P}")
    c = x.shape[0] // P
    out = _reduce(x, mesh, "model", dist.ReduceOp.SUM, "psum_scatter")
    return out[mesh.rank * c:(mesh.rank + 1) * c].clone()


def _group_ranks(mesh: Mesh, axis: str) -> tuple[int, list[int]]:
    """(an id of this rank's group on ``axis``, its members' world ranks
    in group order)."""
    P = mesh.model
    if axis == "model":
        return mesh.data_rank, [mesh.data_rank * P + m for m in range(P)]
    if axis == "data":
        return mesh.rank, [d * P + mesh.rank for d in range(mesh.data)]
    return 0, list(range(mesh.world))


class _IpcBuffers:
    """This process's exported staging buffer on the card and the peers'
    buffers it has mapped, by world rank: each is exported or mapped once
    (a new one only when a gather outgrows it), so no IPC handle is opened
    or released a call."""

    def __init__(self):
        self.buf, self.version, self.args = None, 0, None
        self.peers = {}                 # world rank -> (version, buffer)

    def export(self, nbytes: int, device) -> torch.Tensor:
        from torch.multiprocessing.reductions import reduce_tensor
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None
            self.buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                                   device=device)
            self.version += 1
            self.args = reduce_tensor(self.buf)[1]
        return self.buf

    def peer(self, rank: int, version: int, args) -> torch.Tensor:
        from torch.multiprocessing.reductions import rebuild_cuda_tensor
        held = self.peers.get(rank)
        if held is None or held[0] != version:
            self.peers.pop(rank, None)
            self.peers[rank] = (version, rebuild_cuda_tensor(*args))
        return self.peers[rank][1]


_IPC = _IpcBuffers()


def _ipc_all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
                    group) -> torch.Tensor:
    """``all_gather`` between ranks that share one card: every rank copies
    its tensor into its exported buffer and names the buffer (its CUDA IPC
    handle, once a buffer) in the store; the group meets, each copies the
    others' bytes device to device, and the group meets again before any
    rank writes its buffer anew.  The same bytes as the staged path."""
    import pickle

    store = dist.distributed_c10d._get_default_store()
    gid, ranks = _group_ranks(mesh, axis)
    me = mesh.world_rank
    mesh.ipc_calls[axis] += 1
    tag = f"ipc/{mesh.data}x{mesh.model}/{axis}/{gid}/{mesh.ipc_calls[axis]}"
    x = x.detach().contiguous()
    flat = x.view(-1).view(torch.uint8)
    nb = flat.numel()
    buf = _IPC.export(nb, x.device)
    buf[:nb].copy_(flat)
    torch.cuda.synchronize(x.device)
    store.set(f"{tag}/{me}", pickle.dumps((_IPC.version, _IPC.args)))
    dist.barrier(group=group)
    out = torch.empty((len(ranks),) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    rows = out.view(len(ranks), -1).view(torch.uint8)
    for j, r in enumerate(ranks):
        if r == me:
            rows[j].copy_(flat)
            continue
        version, args = pickle.loads(store.get(f"{tag}/{r}"))
        rows[j].copy_(_IPC.peer(r, version, args)[:nb])
    torch.cuda.synchronize(x.device)
    dist.barrier(group=group)
    store.delete_key(f"{tag}/{me}")
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis="model",
               name: str = "all_gather") -> torch.Tensor:
    """-> ``[n, *x.shape]``, the axis's rank j's ``x`` at index j."""
    n, _, group = _axis(mesh, axis)
    if n == 1:
        return x[None].clone()
    if _ipc(x, mesh):
        return _ipc_all_gather(x, mesh, axis_name(axis), group)
    t0 = time.perf_counter()
    buf, staged = _to_host(x, group)
    out = torch.empty(n * buf.numel(), dtype=x.dtype, device=buf.device)
    dist.all_gather_into_tensor(out, buf.reshape(-1), group=group)
    out = out.reshape((n,) + tuple(x.shape))
    return _back(out, x, mesh, name, staged, t0, axis_name(axis))


# ------------------------------------------------------------ with gradients

def gather_tiled(x, mesh, axis, dim: int, name: str) -> torch.Tensor:
    """All-gather over ``axis``, the parts concatenated along ``dim`` in
    the axis's rank order."""
    parts = all_gather(x.contiguous(), mesh, axis, name)
    if dim == 0:
        return parts.reshape((-1,) + tuple(x.shape[1:]))
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _reduce_scatter(x, mesh, axis, dim: int, name: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, this rank's block along ``dim``
    kept.  Gloo has no reduce-scatter: an all-reduce whose other blocks
    are dropped (the same sums)."""
    n, idx, group = _axis(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"a reduce-scatter of {x.shape[dim]} over {n}")
    c = x.shape[dim] // n
    out = _reduce(x, mesh, axis, dist.ReduceOp.SUM, name)
    return out.narrow(dim, idx * c, c).contiguous()


class _GatherT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return gather_tiled(x, mesh, axis, dim, "ag_fwd")

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim, "ag_bwd"),
                None, None, None)


class _ScatterT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim, "rs_fwd")

    @staticmethod
    def backward(ctx, g):
        return (gather_tiled(g, ctx.mesh, ctx.axis, ctx.dim, "rs_bwd"),
                None, None, None)


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, "model", dist.ReduceOp.SUM,
                       "enter_bwd"), None


class _LeaveModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce(x, mesh, "model", dist.ReduceOp.SUM, "leave_fwd")

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_t(x: torch.Tensor, mesh: Mesh, axis, dim: int = 0):
    """``x`` all-gathered over ``axis`` (a mesh axis or axis tuple),
    tiled along ``dim``; the backward reduce-scatters (``x`` itself over
    an axis of 1)."""
    if _axis(mesh, axis)[0] == 1:
        return x
    return _GatherT.apply(x, mesh, axis, dim)


def scatter_t(x: torch.Tensor, mesh: Mesh, axis, dim: int = 0):
    """The sum of ``x`` over ``axis``, this rank's block along ``dim``;
    the backward all-gathers."""
    if _axis(mesh, axis)[0] == 1:
        return x
    return _ScatterT.apply(x, mesh, axis, dim)


def enter_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The identity; the backward sums the cotangent over 'model'."""
    return x if mesh.model == 1 else _EnterModel.apply(x, mesh)


def leave_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over 'model'; the backward is the identity."""
    return x if mesh.model == 1 else _LeaveModel.apply(x, mesh)


def fold_sum(x: torch.Tensor, mesh: Mesh, axis="data") -> torch.Tensor:
    """The sum of ``x`` over the axis's ranks, added in rank order
    (``((x_0 + x_1) + x_2) + ...``) on every rank from one all-gather, so
    that every rank holds the same bits whatever the backend's reduction
    order."""
    parts = all_gather(x, mesh, axis)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def pmax(x: torch.Tensor, mesh: Mesh, axis="model") -> torch.Tensor:
    """Elementwise max of ``x`` over the axis's ranks (no gradient)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


def world_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise max of ``x`` over every rank of the mesh."""
    return _reduce(x, mesh, "world", dist.ReduceOp.MAX, "max")


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh reaches this point before any leaves it."""
    if mesh.world > 1:
        dist.barrier()


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor | None:
    """The 'model' slabs of an axis-0-sharded array concatenated on the
    host of world rank 0 (``None`` on every other rank).  Only data index
    0 takes part: the other data indices hold the same slabs."""
    if mesh.model == 1:
        return x.detach().cpu() if mesh.world_rank == 0 else None
    if mesh.data_rank != 0:
        return None
    t0 = time.perf_counter()
    buf = x.detach().contiguous().cpu()
    root = dist.get_global_rank(_group(mesh.group), 0)
    parts = ([torch.empty_like(buf) for _ in range(mesh.model)]
             if mesh.rank == 0 else None)
    dist.gather(buf, parts, dst=root, group=mesh.group)
    if x.is_cuda:
        _count(mesh, "gather", "model", buf.numel() * buf.element_size(), t0)
    return torch.cat(parts) if mesh.rank == 0 else None


def _group(group):
    return group if group is not None else dist.group.WORLD


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x [P, ...]`` -> ``[P, ...]``: ``x[j]`` goes to rank j, and index j
    of the result is what rank j sent to this rank."""
    if x.shape[0] != mesh.model:
        raise ValueError(f"all_to_all needs a leading axis of {mesh.model}, "
                         f"got {tuple(x.shape)}")
    if mesh.model == 1:
        return x.clone()
    t0 = time.perf_counter()
    buf, staged = _to_host(x, mesh.group)
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
    buf, staged = _to_host(x, mesh.group)
    out = torch.empty_like(buf)
    group = _group(mesh.group)
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


def _mesh_groups(world: int, data: int, rank: int) -> tuple:
    """(model group, data group) of ``rank`` in the data-major ``(data,
    world / data)`` mesh.  Every rank creates every group, in the same
    order, as ``new_group`` requires."""
    P = world // data
    model_groups = [dist.new_group([d * P + m for m in range(P)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * P + m for d in range(data)])
                   for m in range(P)]
    return model_groups[rank // P], data_groups[rank % P]


def _rank_main(rank: int, fn, world: int, data: int, backend: str,
               device: str, tmp: str, timeout_s: float,
               args: tuple) -> None:
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
        if data == 1:
            model_group, data_group = dist.group.WORLD, None
        else:
            model_group, data_group = _mesh_groups(world, data, rank)
        P = world // data
        mesh = Mesh(model=P, rank=rank % P, device=dev, group=model_group,
                    data=data, data_rank=rank // P, data_group=data_group,
                    one_card=(dev.type == "cuda" and backend == "gloo"
                              and torch.device(device).index is not None))
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, data: int = 1, backend: str = "gloo",
              device: str | None = None, timeout_s: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` rank processes of one
    ``(data, model=world / data)`` mesh; -> the ranks' return values, by
    world rank (``d * P + m``).

    ``fn`` must be importable by name (a module-level function: ``spawn``
    pickles it by reference) and return host data (tensors on the CPU,
    numbers, numpy arrays), which ``torch.save`` carries back.  ``device``
    is every rank's device: None (the default) or "cuda" gives rank r the
    card r, "cuda:0" puts every rank on one card (gloo only), "cpu" runs
    the ranks on the host; asking for a card where there is none raises.
    A rank that raises ends the others, and ``run_ranks`` raises."""
    import torch.multiprocessing as mp

    from repro_torch.device import resolve_device

    if data < 1 or world % data:
        raise ValueError(f"a 'data' axis of {data} does not divide "
                         f"{world} ranks")
    device = "cuda" if device is None else str(device)
    _check_backend(backend, world, device)
    resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, data, backend, device, tmp,
                                 timeout_s, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
