"""Mixture-of-Experts FFN with gather-based capacity dispatch (port of
``repro.nn.moe`` without a mesh).

Dispatch keeps the reference's dense shapes: the router's [T, E] weights R,
each expert's top-C tokens by routing weight (over Rᵀ), the gathered
``xe = x[tok_idx]`` [E, C, d], the expert products as batched
``torch.bmm`` over [E, C, d] x [E, d, f] (plain products, which the
reference also computes outside any Pallas kernel), and the combine as an
``index_add_`` into a [T, d] buffer in the experts' dtype.  Tokens past an
expert's capacity are dropped, smallest weight first.

Both top-k selections break ties by the lower index, as ``jax.lax.top_k``
does: a stable descending sort, cut.  ``torch.topk`` keeps no such order,
and under top-1 routing every routed token's weight is exactly 1.0, so an
over-capacity expert's kept tokens are decided by the tie order alone.

DeepSeek-V3 (sigmoid router, shared + fine-grained routed experts, top-8)
and Llama4-Scout (softmax router, top-1 of 16 + shared) share one config.
The expert-parallel path under a mesh (``moe_apply_sharded``) is not
ported yet: ``moe_dispatch`` raises under an installed ``Mesh``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.attention import LATER
from repro_torch.nn.modules import GluFFN, dense


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per routed expert
    n_experts: int
    top_k: int
    n_shared_experts: int = 0    # shared expert(s) of width n_shared * d_ff
    router: str = "softmax"      # "softmax" | "sigmoid" (DeepSeek-V3)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


def _normal(shape, scale: float, generator, device, dtype) -> nn.Parameter:
    """N(0, scale^2) drawn in place in ``dtype``: no float32 copy of a
    stacked expert weight (one of DeepSeek-V3's is 7.5 GB in bf16)."""
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(generator=generator).mul_(scale)
    return nn.Parameter(w)


class MoE(nn.Module):
    """``router`` (a bias-free dense in float32, whatever the model's
    dtype), the stacked experts ``w_gate`` / ``w_up`` [E, d, f] and
    ``w_down`` [E, f, d], and ``shared`` (a gated FFN of width n_shared *
    d_ff) when ``n_shared_experts`` > 0; named as the reference's leaves."""

    def __init__(self, cfg: MoEConfig, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = dense(d, E, generator, device, bias=False,
                            dtype=torch.float32)
        s = 1.0 / np.sqrt(d)
        self.w_gate = _normal((E, d, f), s, generator, device, dtype)
        self.w_up = _normal((E, d, f), s, generator, device, dtype)
        self.w_down = _normal((E, f, d), 1.0 / np.sqrt(f), generator, device,
                              dtype)
        if cfg.n_shared_experts > 0:
            self.shared = GluFFN(d, cfg.n_shared_experts * f, generator,
                                 device, dtype=dtype)


def moe_init(cfg: MoEConfig, generator: torch.Generator, device,
             dtype: torch.dtype = torch.float32) -> MoE:
    return MoE(cfg, generator, device, dtype)


def moe_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (the
    order of ``jax.lax.top_k``) -> (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoE, cfg: MoEConfig, x: torch.Tensor):
    """x [T, d] -> (logits [T, E] float32, top_w [T, K] normalized, top_i
    [T, K])."""
    logits = F.linear(x.to(torch.float32), p.router.weight)
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(scores, cfg.top_k)
    top_w = top_w / torch.clamp_min(torch.sum(top_w, dim=-1, keepdim=True),
                                    1e-9)
    return logits, top_w, top_i


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """xe [E, C, d] -> [E, C, d]: each expert's SwiGLU on its tokens."""
    h = F.silu(torch.bmm(xe, w_gate))
    h = h * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def dropped(load: torch.Tensor, capacity: int) -> torch.Tensor:
    """The (token, expert) assignments that ``moe_apply`` drops past each
    expert's capacity, from its ``stats``' load and C: a device scalar."""
    return (load - capacity).clamp_min(0).sum()


def moe_apply(p: MoE, cfg: MoEConfig, x: torch.Tensor,
              stats: dict | None = None):
    """x [T, d] -> (out [T, d] in x's dtype, aux scalar float32: the
    Switch load-balance loss, over the softmax's mean for either router).
    ``stats``, where given, receives the capacity ``C`` the dispatch cuts
    at (min(moe_capacity, T)), each expert's ``load`` [E], the router's
    ``logits`` and each token's experts ``top_i``, as device tensors (no
    host sync)."""
    T, d = x.shape
    E = cfg.n_experts
    C = min(moe_capacity(cfg, T), T)
    logits, top_w, top_i = route(p, cfg, x)
    # dense routing matrix R[t, e] = weight if e selected else 0
    R = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    R.scatter_(1, top_i, top_w)
    # per-expert top-C tokens by routing weight (overflow drops smallest)
    pr, tok_idx = top_k(R.T, C)                              # [E, C]
    keep = (pr > 0.0).to(pr.dtype)
    xe = x[tok_idx]                                          # [E, C, d]
    ye = _expert_ffn(p.w_gate, p.w_up, p.w_down, xe)
    ye = ye * (pr * keep)[..., None].to(ye.dtype)
    out = torch.zeros((T, d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, tok_idx.reshape(-1), ye.reshape(-1, d))
    if cfg.n_shared_experts > 0:
        out = out + p.shared(x)
    load = torch.bincount(top_i.reshape(-1), minlength=E)    # [E]
    if stats is not None:
        stats.update(C=C, load=load, logits=logits, top_i=top_i)
    frac_tokens = load.to(torch.float32) / T
    mean_prob = torch.mean(torch.softmax(logits, dim=-1), dim=0)
    aux = E * torch.sum(frac_tokens * mean_prob)
    return out.to(x.dtype), aux


def moe_dispatch(p: MoE, cfg: MoEConfig, x: torch.Tensor):
    """``moe_apply``; under an installed port ``Mesh`` the reference takes
    its expert-parallel path (``inference`` and ``lead`` steer only its
    token sharding), which is not ported yet: raises."""
    from repro_torch.dist.context import current_mesh
    if current_mesh() is not None:
        raise NotImplementedError(f"the MoE under a mesh is {LATER}")
    return moe_apply(p, cfg, x)
