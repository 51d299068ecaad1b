"""Mixture-of-Experts FFN with gather-based capacity dispatch (port of
``repro.nn.moe``).

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

Each expert's weights are drawn from a generator of its own, seeded from
the layer's stream, so a rank of a mesh draws only the experts of its
storage block (``_moe_w_specs``: E over ('data', 'model')) and holds the
same values as one card.  Under an installed ``Mesh``, ``moe_dispatch``
takes the expert-parallel path, ``moe_apply_sharded``: each 'model' rank
computes its E / M experts (gathered over 'data' from their storage
blocks) on its share of the tokens, and the partials combine by ``psum``
(``psum_scatter`` under full-mesh token sharding).  A rank holds the whole
batch's activations: it cuts its token share out and gathers the outputs
back, so the result is the whole [T, d] on every rank.  Capacity and the
aux loss are per token share, as the reference's.  A model stored for
training under a mesh (``dist.tensor_parallel``) takes the reference's
training path instead (``full_token_sharding`` False): its tokens are the
rank's dp share, replicated over 'model', and stay so; the storage
gathers over 'data' carry a reduce-scatter backward, the tokens and the
routing weights enter the experts through ``collectives.enter_model`` and
the combine leaves through ``collectives.leave_model``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import (DP, EP, axes_size, axis_index, block,
                                       block_bounds, resolve_template,
                                       spec_axes)
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


class MoE(nn.Module):
    """``router`` (a bias-free dense in float32, whatever the model's
    dtype), the stacked experts ``w_gate`` / ``w_up`` [E, d, f] and
    ``w_down`` [E, f, d], and ``shared`` (a gated FFN of width n_shared *
    d_ff) when ``n_shared_experts`` > 0; named as the reference's leaves.
    With a mesh, the stacks are this rank's storage blocks."""

    def __init__(self, cfg: MoEConfig, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = dense(d, E, generator, device, bias=False,
                            dtype=torch.float32)
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        spec_g, spec_d = _moe_w_specs(cfg, mesh)
        stacks = {"w_gate": ((d, f), 1.0 / np.sqrt(d), spec_g),
                  "w_up": ((d, f), 1.0 / np.sqrt(d), spec_g),
                  "w_down": ((f, d), 1.0 / np.sqrt(f), spec_d)}
        ids = range(E)
        if mesh is not None:
            ids = range(*block_bounds(mesh, spec_axes(spec_g, 0), E))
        # each stack filled an expert at a time: no whole stack, and no
        # second copy of this rank's block
        for name, (shape, _scale, spec) in stacks.items():
            rows = block(torch.empty(shape, device="meta"), mesh,
                         spec[1:]).shape if mesh is not None else shape
            setattr(self, name, nn.Parameter(torch.empty(
                (len(ids), *rows), device=device, dtype=dtype)))
        if torch.device(device).type == "meta":      # shapes only
            ids = ()
        with torch.no_grad():
            for i, e in enumerate(ids):
                g = torch.Generator(device=device).manual_seed(
                    (base + 0x9E3779B97F4A7C15 * (e + 1)) % 2 ** 63)
                for name, (shape, scale, spec) in stacks.items():
                    w = torch.empty(shape, device=device, dtype=dtype)
                    w.normal_(generator=g).mul_(scale)
                    if mesh is not None:      # the stored rows of d or f
                        w = block(w, mesh, spec[1:])
                    getattr(self, name)[i].copy_(w)
        if cfg.n_shared_experts > 0:
            self.shared = GluFFN(d, cfg.n_shared_experts * f, generator,
                                 device, dtype=dtype)


def moe_init(cfg: MoEConfig, generator: torch.Generator, device,
             dtype: torch.dtype = torch.float32, mesh=None) -> MoE:
    return MoE(cfg, generator, device, dtype, mesh)


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


def _moe_w_specs(cfg: MoEConfig, mesh):
    """Storage specs of the stacked expert weights (w_gate / w_up [E, d,
    f], w_down [E, f, d]), the ``lm_rules`` templates' (``()`` for each
    with no mesh)."""
    if mesh is None:
        return (), ()
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    sg = resolve_template([[EP, "model", "data"], [DP, "pod", "data"], None],
                          (E, d, f), mesh)
    sd = resolve_template([[EP, "model", "data"], None, [DP, "pod", "data"]],
                          (E, f, d), mesh)
    return sg, sd


def _stored(w: torch.Tensor, full: tuple, mesh, spec: tuple):
    """This rank's storage block of a stack whose whole shape is ``full``:
    ``w`` itself when the module holds only its block, the block's view
    when it holds the whole stack (a model built without the mesh)."""
    if tuple(w.shape) == tuple(full):
        return block(w, mesh, spec)
    want = tuple(block(torch.empty(full, device="meta"), mesh, spec).shape)
    if tuple(w.shape) != want:
        raise ValueError(f"an expert stack of {tuple(w.shape)} is neither "
                         f"the whole {tuple(full)} nor this rank's {want}")
    return w


def _gather(w: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather ``w`` over ``axis``, tiled along ``dim``, with no
    gradient (``w`` itself over an axis of 1: no copy of a stack)."""
    if mesh.shape[axis] == 1:
        return w
    return col.gather_tiled(w, mesh, axis, dim, "all_gather")


def _my_experts(p: MoE, cfg: MoEConfig, mesh, gather):
    """The expert stacks down to this 'model' rank's experts, d and f
    whole, gathered from their storage blocks by ``gather(w, mesh, axis,
    dim)``; -> ([w_gate, w_up, w_down], the experts' ids)."""
    E, d, f, M = cfg.n_experts, cfg.d_model, cfg.d_ff, mesh.model
    spec_g, spec_d = _moe_w_specs(cfg, mesh)
    e_axes = spec_axes(spec_g, 0)
    e_extra = tuple(a for a in e_axes if a != "model")
    if e_extra not in ((), ("data",)):
        raise ValueError(f"expert storage over {e_axes}")
    mj = mesh.rank
    ws = []
    for w, spec, dd in ((p.w_gate, spec_g, 1), (p.w_up, spec_g, 1),
                        (p.w_down, spec_d, 2)):
        full = (E, f, d) if dd == 2 else (E, d, f)
        w = _stored(w, full, mesh, spec)
        for a in spec_axes(spec, dd):
            w = gather(w, mesh, a, dd)
        for a in e_extra:
            w = gather(w, mesh, a, 0)
        if not e_axes:            # replicated storage: compute my slice
            sl = E // M
            w = w[mj * sl:(mj + 1) * sl]
        ws.append(w)
    if e_extra:                   # storage E over (data, model): strided
        D = mesh.data
        bs = E // (D * M)
        ids = ((torch.arange(D)[:, None] * M + mj) * bs
               + torch.arange(bs)[None, :]).reshape(-1)
    else:
        bs = E // M
        ids = mj * bs + torch.arange(bs)
    return ws, ids


def moe_train_sharded(p: MoE, cfg: MoEConfig, x: torch.Tensor, mesh,
                      stats: dict | None = None):
    """The expert-parallel MoE of a model stored for training under
    ``mesh`` (the reference's ``moe_apply_sharded`` with
    ``full_token_sharding`` False).  x [T, d] is this rank's dp share,
    replicated over 'model' -> (out [T, d], that share's; aux: that
    share's Switch loss, whose mean over 'data' the step takes).  Its
    collectives carry gradients."""
    T, d = x.shape
    E = cfg.n_experts
    ws, ids = _my_experts(p, cfg, mesh, col.gather_t)
    ids = ids.to(x.device)
    logits, top_w, top_i = route(p, cfg, x)
    R = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    R.scatter_(1, top_i, top_w)
    # this rank's experts read a share of R and of the tokens: their
    # gradients are partial sums over 'model'
    R = col.enter_model(R, mesh)
    xm = col.enter_model(x, mesh)
    C = min(moe_capacity(cfg, T), T)
    pr, tok_idx = top_k(R.T[ids], C)
    keep = (pr > 0.0).to(pr.dtype)
    ye = _expert_ffn(*ws, xm[tok_idx])
    ye = ye * (pr * keep)[..., None].to(ye.dtype)
    out = torch.zeros((T, d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, tok_idx.reshape(-1), ye.reshape(-1, d))
    out = col.leave_model(out, mesh)
    load = torch.bincount(top_i.reshape(-1), minlength=E)
    frac_tokens = load.to(torch.float32) / T
    mean_prob = torch.mean(torch.softmax(logits, dim=-1), dim=0)
    aux = E * torch.sum(frac_tokens * mean_prob)
    if stats is not None:
        stats.update(C=C, ids=ids, load=load, T_loc=T)
    if cfg.n_shared_experts > 0:
        out = out + p.shared(x)
    return out.to(x.dtype), aux


def moe_apply_sharded(p: MoE, cfg: MoEConfig, x: torch.Tensor, mesh,
                      dp_axes: tuple[str, ...],
                      full_token_sharding: bool = False,
                      lead: int | None = None, stats: dict | None = None):
    """The expert-parallel MoE on this rank.  x [T, d], the whole batch's
    -> (out [T, d] in x's dtype, the same on every rank; aux scalar: the
    mean over the token shares of each share's Switch loss).

    Token ladder (the reference's): full mesh when ``full_token_sharding``
    and T divides into dp x M shares and ``lead`` (the caller's batch dim)
    is None or dp_size; then dp-only; then replicated.  Under full-mesh
    sharding a rank's share is gathered over 'model' first and the
    combine is a ``psum_scatter``; else a ``psum`` over 'model'.  Expert
    stacks enter as storage blocks and are gathered over 'data' (and over
    the dp axis their d is stored over) down to "E / M experts, d and f
    whole": 'model' rank m computes experts ``my_expert_ids(m)``.
    ``stats``, where given, receives this rank's C and expert ids.
    Serves only: its collectives carry no gradient, so it raises where
    autograd would record the call (``moe_train_sharded`` trains)."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in p.parameters())):
        raise NotImplementedError(
            "moe_apply_sharded's collectives carry no gradient: train a "
            "model stored for training under the mesh (moe_train_sharded), "
            "or call it under torch.no_grad()")
    T, d = x.shape
    E = cfg.n_experts
    dp_size = axes_size(mesh, dp_axes)
    M = mesh.model
    tokens_full = (full_token_sharding and T % (dp_size * M) == 0
                   and T >= dp_size * M
                   and (lead is None or lead == dp_size))
    tokens_sharded = T % dp_size == 0 and T >= dp_size
    ws, ids = _my_experts(p, cfg, mesh, _gather)
    ids = ids.to(x.device)

    if tokens_full:
        c = T // (dp_size * M)
        w_rank = axis_index(mesh, (*dp_axes, "model"))
        x_loc = x[w_rank * c:(w_rank + 1) * c]
        x_loc = col.all_gather(x_loc, mesh, "model").reshape(-1, d)
    elif tokens_sharded:
        c = T // dp_size
        r = axis_index(mesh, dp_axes)
        x_loc = x[r * c:(r + 1) * c]
    else:
        x_loc = x
    T_loc = x_loc.shape[0]
    logits, top_w, top_i = route(p, cfg, x_loc)
    R = torch.zeros((T_loc, E), dtype=torch.float32, device=x.device)
    R.scatter_(1, top_i, top_w)
    C = min(moe_capacity(cfg, T_loc), T_loc)
    pr, tok_idx = top_k(R.T[ids], C)                      # [e_local, C]
    keep = (pr > 0.0).to(pr.dtype)
    xe = x_loc[tok_idx]
    ye = _expert_ffn(*ws, xe)
    ye = ye * (pr * keep)[..., None].to(ye.dtype)
    out = torch.zeros((T_loc, d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, tok_idx.reshape(-1), ye.reshape(-1, d))
    load = torch.bincount(top_i.reshape(-1), minlength=E)
    frac_tokens = load.to(torch.float32) / T_loc
    mean_prob = torch.mean(torch.softmax(logits, dim=-1), dim=0)
    aux = E * torch.sum(frac_tokens * mean_prob)
    if M > 1:
        out = col.psum_scatter(out, mesh) if tokens_full \
            else col.psum(out, mesh, "model")
        aux = col.psum(aux, mesh, "model") / M
    if tokens_sharded or tokens_full:
        aux = col.psum(aux, mesh, dp_axes) / dp_size
    # back to the whole batch on every rank
    if tokens_full:
        out = col.all_gather(out, mesh, (*dp_axes, "model")).reshape(T, d)
    elif tokens_sharded and dp_size > 1:
        out = col.all_gather(out, mesh, dp_axes).reshape(T, d)
    if stats is not None:
        stats.update(C=C, ids=ids, load=load, T_loc=T_loc)
    if cfg.n_shared_experts > 0:
        out = out + p.shared(x)
    return out.to(x.dtype), aux


def moe_dispatch(p: MoE, cfg: MoEConfig, x: torch.Tensor,
                 inference: bool = False, lead: int | None = None):
    """``moe_train_sharded`` for a model stored for training under a mesh;
    else ``moe_apply_sharded`` under an installed ``Mesh`` (``inference``
    allows the full-mesh token sharding, ``lead`` is the caller's batch
    dim); else ``moe_apply``."""
    from repro_torch.dist.context import current_mesh, dp_axes
    from repro_torch.dist.sharding import stored_mesh, stored_spec
    if stored_spec(p.router.weight) is not None:      # the training layout
        return moe_train_sharded(p, cfg, x, stored_mesh(p.router.weight))
    mesh = current_mesh()
    if mesh is not None:
        return moe_apply_sharded(p, cfg, x, mesh, dp_axes(mesh),
                                 full_token_sharding=inference, lead=lead)
    return moe_apply(p, cfg, x)
