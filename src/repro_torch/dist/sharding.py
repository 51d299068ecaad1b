"""Row-split rules for the arrays sharded over 'model' (the part of
``repro.dist.sharding`` the port needs).

The pool, its optimizer states and the D' store are row-sharded: rank r of
P holds rows ``[r * n / P, (r + 1) * n / P)``.  The reference pads the store
to a multiple of 512 rows so that every mesh axis divides it
(``repro/launch/steps.py:store_rows``); the pad rows have length 0 and are
never looked up.  The reference's PartitionSpec templates and the rule
tables of its launcher have no counterpart here yet (``ROADMAP.md``).
"""
from __future__ import annotations

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
