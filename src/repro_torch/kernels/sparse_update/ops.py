"""Dispatch for the sparse optimizer update: the CUDA kernel for a state on
the card, the plain version for a state on the CPU.

``sparse_update(algo, indices, values, states, *, unique, **hyper)`` is the
one entry point the optimizers call (``repro_torch/optim/sparse.py``), with
the reference's contract (``repro/kernels/sparse_update/ops.py``): sorted
``indices [K]``, unique with a sentinel tail or (``unique=False``) with
duplicate runs folded inside the update.  There is no VMEM gate (the TPU
kernel held the whole state slab on chip; this one reads device memory).
Only Adagrad is ported; sgd and adam come with their kernels.
"""
from __future__ import annotations

from repro_torch.kernels.sparse_update.kernel import sparse_adagrad_cuda
from repro_torch.kernels.sparse_update.ref import sparse_adagrad_ref

ALGOS = ("adagrad",)


def sparse_update(algo: str, indices, values, states: tuple, *,
                  unique: bool = True, **hyper):
    """-> (update_values [K], new_states tuple); states update in place."""
    if algo not in ALGOS:
        raise NotImplementedError(f"sparse {algo}: not ported yet")
    (acc,) = states
    if acc.is_cuda:
        return sparse_adagrad_cuda(indices, values, acc, unique=unique,
                                   **hyper), (acc,)
    if acc.device.type == "cpu":
        return sparse_adagrad_ref(indices, values, acc, unique=unique,
                                  **hyper)
    raise ValueError(f"sparse_update: unsupported device {acc.device}")
