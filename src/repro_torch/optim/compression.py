"""Gradient compression with error feedback (port of
``repro.optim.compression``), for the data-parallel all-reduce: compress
before the reduction, reduce the compressed form, decompress after; the
error-feedback accumulator carries what compression dropped into the next
step (Karimireddy et al., "EF-SGD"), so its bias does not accumulate.

  * ``int8_compress``: stochastic int8 quantization with one float32 scale
    a leaf, ``max(max|x|, 1e-12) / 127``, the noise uniform in [-0.5,
    0.5), one draw a leaf from an explicit ``torch.Generator`` (the
    reference's JAX key), clipped to +-127.
  * ``topk_compress``: the entries of magnitude at least the k-th largest,
    ``k = max(1, int(n * frac))``, as a dense mask (ties kept).

A tree is a dict of named tensors (``named_parameters()`` names, as the
optimizers take) or a single tensor; the error mirrors it in float32.
Nothing on the one-card training path calls these; their use in the
all-reduce comes with the LM under a mesh (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.optimizers import _map


class EFState(NamedTuple):
    error: object                  # float32, the gradients' tree


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def _rebuild(tree, leaves: list):
    return dict(zip(tree, leaves)) if isinstance(tree, dict) else leaves[0]


def _q_int8(x: torch.Tensor, generator: torch.Generator):
    scale = torch.clamp_min(torch.amax(torch.abs(x)), 1e-12) / 127.0
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(x.device) - 0.5
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def _dq_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def int8_compress(grads, ef: EFState, generator: torch.Generator):
    """-> (the tree of ``(q int8, scale float32)``, the new EFState);
    ``corrected = g + error``, ``error' = corrected - q * scale``."""
    qs, new_err = [], []
    for g, e in zip(_leaves(grads), _leaves(ef.error)):
        corrected = g.to(torch.float32) + e
        q, s = _q_int8(corrected, generator)
        qs.append((q, s))
        new_err.append(corrected - _dq_int8(q, s))
    return _rebuild(grads, qs), EFState(_rebuild(grads, new_err))


def int8_decompress(qtree):
    """The tree of ``(q, scale)`` -> float32 ``q * scale``."""
    if isinstance(qtree, dict):
        return {k: _dq_int8(*qs) for k, qs in qtree.items()}
    return _dq_int8(*qtree)


@torch.no_grad()
def topk_compress(grads, ef: EFState, frac: float = 0.01):
    """-> (kept, the new EFState): ``c = g + error``, ``kept = c * (|c| >=
    the k-th largest |c|)``, ``error' = c - kept``."""

    def one(g, e):
        c = g.to(torch.float32) + e
        flat = torch.abs(c.reshape(-1))
        k = max(1, int(flat.shape[0] * frac))
        thresh = torch.topk(flat, k).values[-1]
        kept = c * (torch.abs(c) >= thresh).to(torch.float32)
        return kept, c - kept

    outs = [one(g, e) for g, e in zip(_leaves(grads), _leaves(ef.error))]
    return (_rebuild(grads, [o[0] for o in outs]),
            EFState(_rebuild(grads, [o[1] for o in outs])))


def ef_init(params) -> EFState:
    """A zero float32 error for every leaf of ``params``."""
    return EFState(_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params))
