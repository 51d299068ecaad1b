"""Row-split rules for the arrays sharded over 'model' (the part of
``repro.dist.sharding`` the port needs).

The pool, its optimizer states and the D' store are row-sharded: rank r of
P holds rows ``[r * n / P, (r + 1) * n / P)``, the same on every data
index.  The reference pads the store to a multiple of 512 rows so that
every mesh axis divides it (``repro/launch/steps.py:store_rows``); the pad
rows have length 0 and are never looked up.  Of the buffers only the D'
store shards (the reference's ``buffer_rules``); a CSR store is re-based
per rank (``sharded_memory.shard_csr_buffers``).  A checkpoint holds whole
arrays; ``slab_shardings`` cuts a rank's slabs out of them on restore.  The
reference's PartitionSpec rule tables (``recsys_rules``, ``buffer_rules``)
have no counterpart: nothing in the port consumes them before its
``launch/steps.py`` (``ROADMAP.md``).
"""
from __future__ import annotations

import numpy as np
import torch

STORE_ROW_MULTIPLE = 512


def store_rows(total_vocab: int) -> int:
    """Dense-store rows padded so that every mesh axis divides them."""
    return -(-total_vocab // STORE_ROW_MULTIPLE) * STORE_ROW_MULTIPLE


def pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``x`` with its leading axis padded to ``rows`` with ``fill``."""
    if rows < x.shape[0]:
        raise ValueError(f"cannot pad {x.shape[0]} rows to {rows}")
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def row_slab(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous slab of the leading axis of ``x`` (a copy, so
    the whole array can be freed); ``x`` itself with no mesh or a 'model'
    axis of 1.  Raises unless P divides the rows: the reference then falls
    back to an unsharded lookup, which a rank that holds only its slab
    cannot do."""
    if mesh is None or mesh.model <= 1:
        return x
    n, P = x.shape[0], mesh.model
    if n % P:
        raise ValueError(
            f"{n} rows do not divide over a 'model' axis of {P}; pad them "
            f"(a store to store_rows(n) = {store_rows(n)} rows, with empty "
            "sets and length 0)")
    c = n // P
    return x[mesh.rank * c:(mesh.rank + 1) * c].clone()


def shard_buffers(bufs: dict, mesh) -> dict:
    """This rank's share of a scheme's buffers: the dense store's rows
    (``row_slab``), the CSR store's re-based part; the others whole."""
    if mesh is None or mesh.model <= 1:
        return bufs
    if "store_flat" in bufs:
        from repro_torch.dist.sharded_memory import shard_csr_buffers
        return shard_csr_buffers(bufs, mesh)
    return {k: row_slab(v, mesh) if k in ("store_sets", "store_lengths")
            else v for k, v in bufs.items()}


def is_pool_path(path: str) -> bool:
    """Is a checkpoint leaf at ``path`` a pool slab's (any component named
    ``memory``: the pool, its optimizer moments)?"""
    return "memory" in path.split("/")


def slab_shardings(mesh):
    """The ``shardings`` of ``CheckpointManager.restore`` for ``mesh``:
    ``(path, array) -> array``, this rank's 'model' slab of a pool leaf
    (axis 0 of an array with one), every other leaf whole."""
    def cut(path: str, a):
        if mesh is None or mesh.model <= 1 or not is_pool_path(path) \
                or np.ndim(a) == 0:
            return a
        c = a.shape[0] // mesh.model
        if c * mesh.model != a.shape[0]:
            raise ValueError(f"{path}: {a.shape[0]} rows do not divide over "
                             f"a 'model' axis of {mesh.model}")
        return a[mesh.rank * c:(mesh.rank + 1) * c]
    return cut
