"""The mesh and its thread-local installation (port of
``repro.dist.context``).

A :class:`Mesh` describes one rank of a ``(data=1, model=P)`` mesh: the axis
sizes, this rank's index on 'model', its device and the 'model' process
group.  ``use_mesh(mesh)`` installs it for a ``with`` block; model code
finds it with ``current_mesh()`` and takes the sharded paths
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
    memory (gloo on CUDA tensors, ``repro_torch.dist.collectives``),
    ``staged_bytes`` their payload and ``staged_s`` their host-clock
    seconds, the copies included."""

    model: int                       # P, the 'model' axis size
    rank: int = 0                    # this rank's index on 'model'
    device: torch.device | str = "cpu"
    group: object = None             # the 'model' process group
    data: int = 1
    staged: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    staged_bytes: int = 0
    staged_s: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def __post_init__(self):
        if self.data != 1:
            raise NotImplementedError(
                "a 'data' axis larger than 1 (the batch split and the "
                "gradient reduction over 'data') is not ported yet: see "
                "ROADMAP.md, Queue 1")
        if not 0 <= self.rank < self.model:
            raise ValueError(f"rank {self.rank} outside a 'model' axis of "
                             f"{self.model}")
        self.device = torch.device(self.device)

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
