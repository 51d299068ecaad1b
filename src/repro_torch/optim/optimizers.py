"""Optimizers over a model's named parameters (port of
``repro.optim.optimizers``: ``sgd``, ``adagrad``, ``adam``/``adamw``,
``adafactor``, the transforms ``scale``, ``scale_by_schedule``,
``clip_by_global_norm``, ``chain`` and ``multi_transform``, and the
schedules ``warmup_cosine`` and ``constant``).

The port keeps the reference's explicit ``init`` / ``update`` pair instead of
subclassing ``torch.optim.Optimizer``, for two reasons: the pool's gradient
is a :class:`~repro_torch.optim.sparse.SparseGrad` (indices and values), which
a ``.grad`` tensor cannot carry, and ``multi_transform`` routes by parameter
name, which the pair expresses directly.  A tree is a dict keyed by
``named_parameters()`` names, or a single tensor (``multi_transform`` hands
each routed optimizer one leaf, as the reference's does):

  state = opt.init(params)
  updates, state = opt.update(grads, state, params)
  apply_updates(params, updates)

A state is what the reference's is: Adagrad's accumulators and SGD's
momenta mirror the parameters; Adam's is ``AdamState(step, mu, nu)``, whose
``step`` (a Python int, 0 before the first update) drives the bias
corrections; Adafactor's ``AdafactorState(step, vs)``; ``chain``'s a
tuple, ``multi_transform``'s a dict of each parameter's own state.
Moments and parameters are updated in place (the pool's moments are as
large as the pool, so a functional copy per step would double them); the
step counters are new values in the returned state.  A parameter with no gradient is skipped (the reference sees a zero
gradient there; no model of the port leaves a parameter out of its loss).
``torch.optim`` is not used: its fused updates (``addcdiv_`` and the like)
round differently from the reference's formulas, which are kept here one
rounded operation at a time.
"""
from __future__ import annotations

import math
import re
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (updates, state)


def _is_sparse(x) -> bool:
    from repro_torch.optim.sparse import SparseGrad
    return isinstance(x, SparseGrad)


def _map(fn, tree, *rest):
    """``fn`` over a dict of named leaves (the others looked up by name) or
    over one leaf."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _unzip(out, *states):
    """A tree of tuples -> (updates, *new states); a dict state keeps the
    entries of parameters that had no gradient."""
    if not isinstance(out, dict):
        return out
    n = len(states) + 1
    parts = [{k: o[i] for k, o in out.items()} for i in range(n)]
    return (parts[0],) + tuple({**s, **p} for s, p in zip(states,
                                                          parts[1:]))


def _scaled(x, factor):
    """``x * factor``; a SparseGrad's values are scaled, its indices kept."""
    if _is_sparse(x):
        return x.map_values(lambda v: v * factor)
    return x * factor


def bias_correction(b: float, step: int) -> float:
    """``1 - b ** step`` as the reference computes it (float32 ``b`` to the
    power of the float32 step, then float32 ``1 -``), returned as the
    float32 value.  PyTorch's CPU power of two 0-dim float32 tensors gives
    XLA's bits at every step measured (1 to 20,000, b = 0.9 and 0.999); its
    vectorized power and numpy's float32 power do not."""
    p = torch.tensor(b, dtype=torch.float32) ** torch.tensor(
        float(step), dtype=torch.float32)
    return float(1 - p)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> None:
    """``p += u`` in place; a SparseGrad update is an O(K) scatter-add."""
    from repro_torch.optim import sparse as sp
    for k, u in updates.items():
        if sp.is_sparse(u):
            sp.sparse_apply(params[k], u)
        else:
            params[k].add_(u.to(params[k].dtype))


# ------------------------------------------------------------------ transforms

def scale(factor: float) -> Optimizer:
    return Optimizer(lambda params: (),
                     lambda g, s, p=None: (_map(lambda x: _scaled(x, factor),
                                                g), s))


def scale_by_schedule(schedule: Callable[[int], float]) -> Optimizer:
    """Scale by ``schedule(step)``, the step counted from 0 in the state."""

    def update(g, step, p=None):
        lr = schedule(step)
        return _map(lambda x: _scaled(x, lr), g), step + 1

    return Optimizer(lambda params: 0, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-9))``, the norm
    over all leaves (a SparseGrad's values, as in the reference), summed
    leaf by leaf in the order of their sorted names (the reference's tree
    order).  Under an installed mesh the norm is the global one: a dense
    pool gradient that is a rank's 'model' slab (a ``memory`` leaf) gives
    its slab's sum of squares summed over 'model' in rank order; every
    other leaf is whole on every rank (a SparseGrad holds the global
    batch's stream, and dense gradients are reduced over 'data' before the
    optimizer runs).  The leaves of a model stored for training under the
    mesh are blocks (``sharding.stored_spec``): each distinct block counts
    once (its replicas over the axes its spec leaves out count nothing),
    and the sum runs over the world."""
    from repro_torch.kernels.sparse_update.ref import ieee_sqrt

    def square_sum(name, x):
        sq = torch.sum(torch.square(
            (x.values if _is_sparse(x) else x).to(torch.float32)))
        if name is None or _is_sparse(x) or name.split(".")[-1] != "memory":
            return sq
        from repro_torch.dist.context import current_mesh
        mesh = current_mesh()
        if mesh is None or mesh.model <= 1:
            return sq
        from repro_torch.dist import collectives as col
        return col.fold_sum(sq.reshape(1), mesh, "model")[0]

    def update(g, s, p=None):
        named = [(k, g[k]) for k in sorted(g)] if isinstance(g, dict) \
            else [(None, g)]
        specs = _block_specs(p)
        if specs:
            from repro_torch.dist import collectives as col
            mesh = _block_mesh(p)
            sq = sum(torch.sum(torch.square(x.to(torch.float32)))
                     * _counts_once(mesh, specs[k]) for k, x in named)
            gn = ieee_sqrt(col.fold_sum(sq.reshape(1), mesh, "world")[0])
        else:
            gn = ieee_sqrt(sum(square_sum(k, x) for k, x in named))
        factor = torch.clamp(torch.full_like(gn, max_norm)
                             / torch.clamp(gn, min=1e-9), max=1.0)
        return _map(lambda x: _scaled(x, factor), g), s

    return Optimizer(lambda params: (), update)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """``new = momentum * mo + g; u = -lr * new`` (no state without
    momentum); SparseGrad leaves go to the lazy sparse kernel
    (``optim.sparse.sgd_leaf``)."""

    def init(params):
        if momentum == 0.0:
            return ()
        return _map(torch.zeros_like, params)

    @torch.no_grad()
    def update(g, mo, p=None):
        if momentum == 0.0:
            return _map(lambda x: _scaled(x, -lr), g), mo
        from repro_torch.optim.sparse import sgd_leaf
        return _unzip(_map(lambda x, m: sgd_leaf(x, m, lr=lr,
                                                 momentum=momentum), g, mo),
                      mo)

    return Optimizer(init, update)


def adagrad(lr: float, eps: float = 1e-10,
            initial_acc: float = 0.0) -> Optimizer:
    """Adagrad with the reference's formula: ``acc += g * g;
    u = -lr * g / (sqrt(acc) + eps)``; SparseGrad leaves go to the sparse
    kernel (``optim.sparse.adagrad_leaf``)."""

    def init(params):
        return _map(lambda p: torch.full_like(p, initial_acc,
                                              dtype=torch.float32), params)

    @torch.no_grad()
    def update(g, acc, p=None):
        from repro_torch.optim.sparse import adagrad_leaf
        return _unzip(_map(lambda x, a: adagrad_leaf(x, a, lr=lr, eps=eps),
                           g, acc), acc)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: int                      # the global step, 0 before the first
    mu: object
    nu: object


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with global-step bias corrections and decoupled weight decay:
    ``mu = b1 mu + (1-b1) g; nu = b2 nu + (1-b2) g^2;
    u = -lr (mu / bc1) / (sqrt(nu / bc2) + eps) - lr wd p``.  A SparseGrad
    leaf takes the lazy sparse kernel (``optim.sparse.adam_leaf``)."""
    return _adam(lr, b1, b2, eps, weight_decay, AdamState, lambda x: x.shape)


def _adam(lr, b1, b2, eps, weight_decay, state_cls, nu_shape) -> Optimizer:
    """Adam's init and update; ``nu_shape(param)`` is the shape of a leaf's
    second moment (``sparse_rowwise_adam`` gives a row-wise one) and
    ``state_cls(step, mu, nu)`` the state."""

    def init(params):
        def zeros(shape_of):
            return _map(lambda x: torch.zeros(shape_of(x), dtype=torch.float32,
                                              device=x.device), params)
        return state_cls(0, zeros(lambda x: x.shape), zeros(nu_shape))

    @torch.no_grad()
    def update(g, state, params=None):
        from repro_torch.optim.sparse import adam_leaf
        step = state.step + 1
        bc1, bc2 = bias_correction(b1, step), bias_correction(b2, step)

        def leaf(x, m, n, p):
            return adam_leaf(x, m, n, None if _is_sparse(p) else p, lr=lr,
                             b1=b1, b2=b2, bc1=bc1, bc2=bc2, eps=eps,
                             weight_decay=weight_decay)

        out = _map(leaf, g, state.mu, state.nu,
                   params if params is not None else g)
        updates, mu, nu = _unzip(out, state.mu, state.nu)
        return updates, state_cls(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def _block_specs(params) -> dict:
    """{name: spec} of the parameters stored as ``lm_rules`` blocks
    (``sharding.stored_spec``), {} when there are none."""
    if not isinstance(params, dict):
        return {}
    from repro_torch.dist.sharding import stored_spec
    specs = {k: stored_spec(p) for k, p in params.items()}
    if all(v is None for v in specs.values()):
        return {}
    return {k: v if v is not None else () for k, v in specs.items()}


def _block_mesh(params: dict):
    """The mesh of the parameters' ``lm_rules`` blocks."""
    from repro_torch.dist.sharding import stored_mesh
    return next(m for m in map(stored_mesh, params.values())
                if m is not None)


def _spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis ``spec`` splits a dim over, in mesh order."""
    from repro_torch.dist.sharding import spec_axes
    used = {a for i in range(len(spec)) for a in spec_axes(spec, i)}
    return tuple(a for a in ("data", "model") if a in used)


def _counts_once(mesh, spec) -> float:
    """1 on the one rank of each block's replicas that counts it (index 0
    on every axis ``spec`` leaves out), else 0."""
    used = _spec_axes(spec)
    return float(("data" in used or mesh.data_rank == 0)
                 and ("model" in used or mesh.rank == 0))


def _drop(spec: tuple, dim: int) -> tuple:
    """``spec`` without the entry of ``dim``."""
    dim = dim % len(spec)
    return spec[:dim] + spec[dim + 1:]


def _block_mean(x: torch.Tensor, dim: int, spec: tuple, mesh,
                n: int) -> torch.Tensor:
    """The mean over ``dim`` of the whole leaf whose block is ``x``, whole
    on every rank: the block's sums placed in the whole statistic and
    summed over the axes ``spec`` splits (each block counted once)."""
    from repro_torch.dist import collectives as col
    from repro_torch.dist.sharding import block, whole_shape
    rest = _drop(spec, dim)
    part = torch.sum(x, dim=dim)
    full = torch.zeros(whole_shape(part.shape, rest, mesh.shape),
                       dtype=part.dtype, device=part.device)
    block(full, mesh, rest)[...] = part
    axes = _spec_axes(spec)
    if axes:
        full = col.psum(full, mesh, axes)
    return full / n


class AdafactorState(NamedTuple):
    step: int                      # the global step, 0 before the first
    vs: object                     # by name: {"v_row", "v_col"} or {"v"}


# The reference keeps an LM layer group's parameters stacked, [count, ...],
# and the port one module a layer, ``layers_{g}.{i}.<name>``
# (``convert.lm_params_from_jax``); ``_map_leading`` updates a stacked leaf
# layer by layer past this many bytes (at 4 bytes an element)
_LAYER = re.compile(r"^(layers_\d+)\.\d+\.(.+)$")
MAP_LEADING_BYTES = 1 << 27


def _transposed(name: str | None, shape) -> bool:
    """A Linear's ``weight [out, in]`` is the reference's ``kernel [in,
    out]``; every other parameter keeps the reference's layout."""
    return name is not None and name.endswith(".weight") and len(shape) == 2


def _mapped(shape) -> bool:
    """``_map_leading``'s test on a reference leaf's shape."""
    return (len(shape) >= 3 and shape[0] > 1
            and math.prod(shape) * 4 > MAP_LEADING_BYTES)


def _clip_units(shapes: dict) -> list[list]:
    """The leaves of the reference's update, each as the names of the
    parameters whose updates share one RMS clip: all layers of one
    ``layers_{g}.*.<name>`` (the stacked leaf), or each layer alone when
    the stacked leaf is mapped; any other parameter is its own leaf."""
    groups: dict = {}
    for k in shapes:
        m = _LAYER.match(k) if k is not None else None
        groups.setdefault(m.groups() if m else k, []).append(k)
    units = []
    for key, names in groups.items():
        if isinstance(key, tuple) and _mapped(
                (len(names),) + tuple(shapes[names[0]])):
            units.extend([k] for k in names)
        else:
            units.append(names)
    return units


def adafactor(lr: float, decay_exp: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              min_factor_dim: int = 128) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) with the reference's formulas: the
    second moment of an ``[..., n, m]`` leaf with both n, m >= 128 kept as
    row and column means (``v_row`` [..., n], ``v_col`` [..., m]), else in
    full (``v``); ``beta2 = 1 - step ** -decay_exp``; ``u = g /
    sqrt(vhat + eps)`` divided by ``max(1, rms(u) / clip_threshold)``;
    update ``-lr u`` in the gradient's dtype.

    The layouts are the reference's: ``v_row`` runs over a kernel's input
    rows (a ``weight``'s columns), ``v_col`` over its outputs, a MoE expert
    stack's moments are per expert over its last two axes, and ``v``
    mirrors the parameter.  The RMS clip is taken over the reference's leaf
    (``_clip_units``): every layer of a layer group together, or each layer
    alone where the reference maps the stacked leaf layer by layer.  Two
    layouts no registered config has are refused: a 1-D parameter of a
    group of 128 layers or more (the reference factors it across them),
    and a parameter outside the layer groups that the reference maps by
    its leading axis (3-D and over ``MAP_LEADING_BYTES``).
    The whole named tree is one update (as the launcher builds it); a lone
    tensor is its own leaf.  A SparseGrad is densified (the factored moment
    is global), in the parameter's layout.

    Over the blocks of a model stored for training under a mesh
    (``sharding.stored_spec``): ``v`` is the parameter's block (the update
    is elementwise there), ``v_row`` and ``v_col`` are whole on every rank
    (as the reference's rules leave them), their means summed over the
    axes that split the other dim, and the RMS clip's sum of squares runs
    over the world, each block counted once."""

    def factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_factor_dim
                and shape[-2] >= min_factor_dim)

    def whole(specs, k, x, mesh) -> tuple:
        if k not in specs:
            return tuple(x.shape)
        from repro_torch.dist.sharding import whole_shape
        return whole_shape(x.shape, specs[k], mesh.shape)

    def init(params):
        named = params if isinstance(params, dict) else {None: params}
        specs = _block_specs(params)
        mesh = _block_mesh(params) if specs else None
        counts: dict = {}
        for k in named:
            m = _LAYER.match(k) if k is not None else None
            if m:
                counts[m.groups()] = counts.get(m.groups(), 0) + 1

        def one(k, x):
            shape = whole(specs, k, x, mesh)
            if _transposed(k, shape):
                shape = shape[::-1]
            m = _LAYER.match(k) if k is not None else None
            if m and x.dim() == 1 and factored((counts[m.groups()],) + shape):
                raise NotImplementedError(
                    f"{k}: a 1-D parameter factored across the "
                    f"{counts[m.groups()]} layers of its group")
            if not m and _mapped(shape):
                raise NotImplementedError(
                    f"{k}: a {shape} parameter clipped by its leading axis")
            zeros = lambda s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                          device=x.device)
            if factored(shape):
                return {"v_row": zeros(shape[:-1]),
                        "v_col": zeros(shape[:-2] + shape[-1:])}
            return {"v": zeros(x.shape)}

        vs = {k: one(k, x) for k, x in named.items()}
        return AdafactorState(0, vs if isinstance(params, dict) else vs[None])

    def second_moment(k, g2, v, b2, ob2, spec=None, mesh=None):
        """vhat in the parameter's layout (its block under ``spec`` over
        ``mesh``); the moments updated in place."""
        if "v" in v:
            return v["v"].mul_(b2).add_(g2.mul_(ob2))
        tr = _transposed(k, g2.shape)
        row, col = v["v_row"], v["v_col"]
        dr, dc = (-2, -1) if tr else (-1, -2)
        if spec is None:
            mr, mc = torch.mean(g2, dim=dr), torch.mean(g2, dim=dc)
        else:
            from repro_torch.dist.sharding import block
            mr = _block_mean(g2, dr, spec, mesh, col.shape[-1])
            mc = _block_mean(g2, dc, spec, mesh, row.shape[-1])
        row.mul_(b2).add_(mr.mul_(ob2))
        col.mul_(b2).add_(mc.mul_(ob2))
        r = row / torch.clamp(torch.mean(row, dim=-1, keepdim=True), min=eps)
        if spec is not None:
            r = block(r, mesh, _drop(spec, dr))
            col = block(col, mesh, _drop(spec, dc))
        if tr:
            return col[:, None] * r[None, :]
        return r[..., :, None] * col[..., None, :]

    @torch.no_grad()
    def update(grads, state, params=None):
        from repro_torch.kernels.sparse_update.ref import div, ieee_sqrt
        one = not isinstance(grads, dict)
        named = {None: grads} if one else grads
        vs = {None: state.vs} if one else state.vs
        step = state.step + 1
        b2 = 1 - torch.tensor(float(step), dtype=torch.float32) ** \
            torch.tensor(-decay_exp, dtype=torch.float32)
        b2, ob2 = float(b2), float(1 - b2)
        dense = {}
        for k, g in named.items():
            if _is_sparse(g):
                g = g.densify()
                ref = vs[k].get("v")
                if ref is not None and g.shape != ref.shape:
                    g = g.reshape(ref.shape)
            dense[k] = g
        specs = {} if one else _block_specs(params)
        mesh = _block_mesh(params) if specs else None
        shapes = {k: whole(specs, k, g, mesh) for k, g in dense.items()}
        units = _clip_units(shapes)
        us, ssq = {}, []
        for names in units:
            for k in names:
                gf = dense[k].to(torch.float32)
                vhat = second_moment(k, torch.square(gf).add_(eps), vs[k],
                                     b2, ob2, specs.get(k), mesh)
                us[k] = gf * torch.rsqrt(vhat + eps)
            # mean(u^2) over the leaf, summed in float64 (XLA's float32 sum
            # of a large stacked leaf strays past 1e-6 relative)
            ssq.append(sum(torch.sum(torch.square(us[k]),
                                     dtype=torch.float64)
                           * (_counts_once(mesh, specs[k]) if specs else 1)
                           for k in names))
        if specs:
            from repro_torch.dist import collectives as col
            ssq = list(col.fold_sum(torch.stack(ssq), mesh, "world"))
        updates = {}
        for names, sq in zip(units, ssq):
            mean = (sq / sum(math.prod(shapes[k]) for k in names)).to(
                torch.float32)
            factor = torch.clamp(div(ieee_sqrt(mean + eps), clip_threshold),
                                 min=1.0)
            for k in names:
                updates[k] = _scaled(us[k] / factor, -lr).to(dense[k].dtype)
        return (updates[None] if one else updates), AdafactorState(
            step, state.vs)

    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(g, states, params=None):
        new_states = []
        for t, s in zip(transforms, states):
            g, s = t.update(g, s, params)
            new_states.append(s)
        return g, tuple(new_states)

    return Optimizer(init, update)


def multi_transform(rules: list[tuple[str, Optimizer]],
                    default: Optimizer) -> Optimizer:
    """Route each parameter by name (first regex that matches wins), e.g.
    ``[(r"(^|\\.)memory$", sparse_adagrad(lr))]`` for the pool.  Each
    parameter keeps the state its optimizer builds for it alone (one Adam
    step counter per parameter, as in the reference)."""

    def route(name: str) -> Optimizer:
        for pat, opt in rules:
            if re.search(pat, name):
                return opt
        return default

    def init(params: dict) -> dict:
        return {k: route(k).init(p) for k, p in params.items()}

    def update(grads: dict, states: dict, params: dict):
        updates, states = {}, dict(states)
        for k, g in grads.items():
            updates[k], states[k] = route(k).update(g, states[k], params[k])
        return updates, states

    return Optimizer(init, update)


# ------------------------------------------------------------------- schedules

def _step32(step) -> torch.Tensor:
    """The step ``scale_by_schedule`` passes (a Python int or an integer
    tensor) as a float32 0-dim tensor, as the reference's
    ``step.astype(float32)``."""
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.0) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor`` at ``total``; -> a float32 0-dim tensor.  The
    reference's float32 arithmetic, one operation at a time (Python floats
    combine first, as there, then round to float32 against the step)."""

    def schedule(step) -> torch.Tensor:
        step = _step32(step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return torch.where(step < warmup, warm, cos)

    return schedule


def constant(lr: float) -> Callable:
    """``lr`` at every step, a float32 0-dim tensor."""
    return lambda step: torch.tensor(lr, dtype=torch.float32)
