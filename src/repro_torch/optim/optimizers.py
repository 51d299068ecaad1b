"""Optimizers over a model's named parameters (port of
``repro.optim.optimizers``; Adagrad, the arch optimizer of the main path).

The port keeps the reference's explicit ``init`` / ``update`` pair instead of
subclassing ``torch.optim.Optimizer``, for two reasons: the pool's gradient
is a :class:`~repro_torch.optim.sparse.SparseGrad` (indices and values), which
a ``.grad`` tensor cannot carry, and ``multi_transform`` routes by parameter
name, which the pair expresses directly.  The trees are plain dicts keyed by
``named_parameters()`` names:

  state = opt.init(params)
  updates, state = opt.update(grads, state, params)
  apply_updates(params, updates)

State and parameters are updated in place (the pool's accumulator is as
large as the pool, so a functional copy per step would double it).  A
parameter with no gradient is skipped, which for Adagrad is what a zero
gradient does.  ``torch.optim.Adagrad`` is not used: its ``addcdiv_``
rounds differently from the reference's ``-lr * g / (sqrt(acc) + eps)``.
"""
from __future__ import annotations

import re
from typing import Callable

import torch


class Optimizer:
    """Per-leaf ``init_leaf(p) -> state`` and ``update_leaf(g, state, p) ->
    (update, state)``, mapped over dicts of named tensors."""

    def __init__(self, init_leaf: Callable, update_leaf: Callable):
        self.init_leaf = init_leaf
        self.update_leaf = update_leaf

    def init(self, params: dict) -> dict:
        return {k: self.init_leaf(p) for k, p in params.items()}

    def update(self, grads: dict, state: dict, params: dict):
        updates = {}
        for k, g in grads.items():
            updates[k], state[k] = self.update_leaf(g, state[k], params[k])
        return updates, state


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> None:
    """``p += u`` in place; a SparseGrad update is an O(K) scatter-add."""
    from repro_torch.optim import sparse as sp
    for k, u in updates.items():
        if sp.is_sparse(u):
            sp.sparse_apply(params[k], u)
        else:
            params[k].add_(u.to(params[k].dtype))


def adagrad(lr: float, eps: float = 1e-10,
            initial_acc: float = 0.0) -> Optimizer:
    """Adagrad with the reference's formula: ``acc += g * g;
    u = -lr * g / (sqrt(acc) + eps)``; SparseGrad leaves go to the sparse
    kernel (``optim.sparse.adagrad_leaf``)."""

    def init_leaf(p):
        return torch.full_like(p, initial_acc, dtype=torch.float32)

    @torch.no_grad()
    def update_leaf(g, acc, p):
        from repro_torch.optim.sparse import adagrad_leaf
        return adagrad_leaf(g, acc, p, lr=lr, eps=eps)

    return Optimizer(init_leaf, update_leaf)


class _MultiTransform(Optimizer):
    def __init__(self, rules: list[tuple[str, Optimizer]], default: Optimizer):
        self.rules, self.default = rules, default

    def route(self, name: str) -> Optimizer:
        for pat, opt in self.rules:
            if re.search(pat, name):
                return opt
        return self.default

    def init(self, params: dict) -> dict:
        return {k: self.route(k).init_leaf(p) for k, p in params.items()}

    def update(self, grads: dict, state: dict, params: dict):
        updates = {}
        for k, g in grads.items():
            updates[k], state[k] = self.route(k).update_leaf(g, state[k],
                                                             params[k])
        return updates, state


def multi_transform(rules: list[tuple[str, Optimizer]],
                    default: Optimizer) -> Optimizer:
    """Route each parameter by name (first regex that matches wins), e.g.
    ``[(r"(^|\\.)memory$", sparse_adagrad(lr))]`` for the pool."""
    return _MultiTransform(rules, default)
