"""The mesh and its thread-local installation (port of
``repro.dist.context``).

A :class:`Mesh` describes one rank of a ``(data=D, model=P)`` mesh: the
axis sizes, this rank's index on each axis, its device and one process
group per axis ('model': the ranks with this data index; 'data': the ranks
with this model index).  The world is numbered data-major, as the
reference's ``jax.make_mesh((D, P), ("data", "model"))``: world rank
``d * P + m``.  ``use_mesh(mesh)`` installs it for a ``with`` block; model
code finds it with ``current_mesh()`` and takes the sharded paths
(``repro_torch.embed.backends.ShardedBackend``).  The installation is
thread-local, as in the reference.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import torch

_state = threading.local()


@dataclasses.dataclass
class Mesh:
    """One rank's view of a ``(data, model)`` mesh.

    ``staged`` counts, by collective, the calls that went through host
    memory (gloo on CUDA tensors, ``repro_torch.dist.collectives``): a
    'model' collective by its name, another axis's as ``name/axis``.
    ``staged_bytes`` is their payload and ``staged_s`` their host-clock
    seconds, the copies included; ``axis_bytes`` and ``axis_s`` split the
    same by axis ('model', 'data', 'world').  ``one_card``: every rank
    of the mesh lies on this rank's card (gloo ranks sharing one GPU), so
    a large ``all_gather`` reads the others' tensors through CUDA IPC
    (``ipc_calls``, by axis) instead of staging them."""

    model: int                       # P, the 'model' axis size
    rank: int = 0                    # this rank's index on 'model'
    device: torch.device | str = "cpu"
    group: object = None             # the 'model' process group
    data: int = 1                    # D, the 'data' axis size
    data_rank: int = 0               # this rank's index on 'data'
    data_group: object = None        # the 'data' process group
    one_card: bool = False           # every rank on this rank's card
    staged: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    staged_bytes: int = 0
    staged_s: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    axis_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    axis_s: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    ipc_calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def __post_init__(self):
        if not 0 <= self.rank < self.model:
            raise ValueError(f"rank {self.rank} outside a 'model' axis of "
                             f"{self.model}")
        if not 0 <= self.data_rank < self.data:
            raise ValueError(f"data rank {self.data_rank} outside a 'data' "
                             f"axis of {self.data}")
        self.device = torch.device(self.device)

    @property
    def world(self) -> int:
        """The number of ranks, D * P."""
        return self.data * self.model

    @property
    def world_rank(self) -> int:
        """This rank's place in the data-major world: d * P + m."""
        return self.data_rank * self.model + self.rank

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("data", "model")


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the ambient mesh for this thread."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_mesh() -> Mesh | None:
    """The installed mesh, or None (single-device paths)."""
    return getattr(_state, "mesh", None)


def axis_sizes(mesh: Mesh | None = None) -> dict:
    mesh = current_mesh() if mesh is None else mesh
    return {} if mesh is None else dict(mesh.shape)


def dp_axes(mesh: Mesh | None = None) -> tuple[str, ...]:
    """The data-parallel axes the mesh has, of ('pod', 'data')."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def constrain(x: torch.Tensor, template) -> torch.Tensor:
    """The identity.  The reference pins an activation's XLA sharding here;
    a rank of the port holds plain local tensors, and where a tensor lives
    is decided by the code that builds it, so there is nothing to pin."""
    return x
