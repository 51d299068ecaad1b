"""Dispatch for the sparse optimizer update: the CUDA kernel for states on
the card, the plain version for states on the CPU.

``sparse_update(algo, indices, values, states, *, unique, **hyper)`` is the
one entry point the optimizers call (``repro_torch/optim/sparse.py``), for
``algo`` in ``ALGOS`` and with the reference's contract
(``repro/kernels/sparse_update/ops.py``): sorted ``indices [K]``, unique with
a sentinel tail or (``unique=False``) with duplicate runs folded inside the
update; flat ``[m]`` states with ``[K]`` values or ``[rows, d]`` states with
``[K, d]`` values, and Adam's row-wise ``nu [rows]``.  Momentum-less SGD has
no state and no kernel (``-lr * values``, as in the reference).  There is no
VMEM gate (the TPU kernel held the whole state slab on chip; these read
device memory).
"""
from __future__ import annotations

from repro_torch.kernels.sparse_update.kernel import (sparse_adagrad_cuda,
                                                      sparse_adam_cuda,
                                                      sparse_sgd_cuda)
from repro_torch.kernels.sparse_update.ref import (sparse_adagrad_ref,
                                                   sparse_adam_ref,
                                                   sparse_sgd_ref)

ALGOS = ("sgd", "adagrad", "adam")


def _shapes_ok(algo: str, values, states) -> bool:
    """The layouts the kernels take (the reference's ``_shapes_ok``): flat
    states with [K] values or [rows, d] states with [K, d] values; only
    Adam's second moment may drop to [rows] against [K, d] values."""
    if values.dim() > 2:
        return False
    if algo == "adam" and len(states) == 2:
        return (states[0].dim() == values.dim()
                and states[1].dim() in (1, values.dim()))
    return all(s.dim() == values.dim() for s in states)


def sparse_update(algo: str, indices, values, states: tuple, *,
                  unique: bool = True, **hyper):
    """-> (update_values [K, ...], states tuple); states update in place."""
    if algo not in ALGOS:
        raise ValueError(f"sparse {algo}: not one of {ALGOS}")
    if algo == "sgd" and (not states or hyper.get("momentum", 0.0) == 0.0):
        return sparse_sgd_ref(indices, values, None, unique=unique, **hyper)
    if not _shapes_ok(algo, values, states):
        raise ValueError(f"sparse {algo}: states "
                         f"{[tuple(s.shape) for s in states]} do not fit "
                         f"values {tuple(values.shape)}")
    lead = states[0]
    if lead.is_cuda:
        kernel = {"sgd": sparse_sgd_cuda, "adagrad": sparse_adagrad_cuda,
                  "adam": sparse_adam_cuda}[algo]
        return kernel(indices, values, *states, unique=unique,
                      **hyper), tuple(states)
    if lead.device.type == "cpu":
        plain = {"sgd": sparse_sgd_ref, "adagrad": sparse_adagrad_ref,
                 "adam": sparse_adam_ref}[algo]
        return plain(indices, values, *states, unique=unique, **hyper)
    raise ValueError(f"sparse_update: unsupported device {lead.device}")
