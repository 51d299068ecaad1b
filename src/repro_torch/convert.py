"""Carry reference (JAX) parameters, buffers and trainer states across to
the port.

The two packages' random generators differ, so parameters always cross as
numpy arrays: the caller converts the reference pytree with ``np.asarray``
leaf by leaf, and these functions name and lay them out for the port.
``state_to_jax`` / ``state_from_jax`` do the same for a Trainer's whole
durable state (what its checkpoints hold), so a checkpoint of either
package's Trainer resumes in the other's.  ``lm_params_from_jax`` lays a
reference LM's stacked parameters out as the port's per-layer modules, and
``cache_from_jax`` / ``cache_to_jax`` carry a decode cache both ways;
``gnn_params_from_jax`` names a reference GAT's parameters for the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.manager import _flatten, _host, _unflatten
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (block, lm_rules, lm_spec,
                                       rank_share, row_slab, shard_buffers)
from repro_torch.models.recsys import RecsysConfig


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)   # a writable, contiguous copy


def params_from_jax(np_params: dict, cfg: RecsysConfig, device=None,
                    mesh=None) -> dict:
    """Reference recsys parameter pytree (numpy leaves) -> the port's
    ``Recsys`` state dict, on the card unless ``device`` says otherwise.

    The embedding parameters copy straight across by name (``memory``;
    ``table_{t}`` of full and md, md's ``proj_{t}``; qr's ``q_{t}`` and
    ``r_{t}``; xDeepFM's ``linear`` table too), and so do xDeepFM's CIN
    weights (``cin.layer_{i}``, [Ho, Hk, F]); a dense ``kernel [in, out]``
    becomes ``Linear.weight [out, in]`` (transposed) and ``bias`` copies:
    DLRM's ``bot`` and ``top``, DCN-v2's ``cross.layer_{i}``, ``deep`` and
    ``head``, xDeepFM's ``cin_out`` and ``deep``, DIN's ``att`` and
    ``head``.  With a mesh, each ``memory`` pool is this rank's slab of
    it."""
    dev = resolve_device(device)
    tables = ("embedding", "linear") if cfg.model == "xdeepfm" \
        else ("embedding",)
    state = {f"{t}.{k}": _tensor(v, dev)
             for t in tables for k, v in np_params[t].items()}
    for t in tables:
        if "memory" in np_params[t]:
            state[f"{t}.memory"] = row_slab(state[f"{t}.memory"], mesh)
    if cfg.model == "xdeepfm":
        for name, w in np_params["cin"].items():
            state[f"cin.{name}"] = _tensor(w, dev)
    denses = {"dlrm": (), "dcn": ("head",), "xdeepfm": ("cin_out",),
              "din": ()}[cfg.model]
    mlps = {"dlrm": ("bot", "top"), "dcn": ("cross", "deep"),
            "xdeepfm": ("deep",), "din": ("att", "head")}[cfg.model]
    for name in denses:
        _dense_into(state, name, np_params[name], dev)
    for mlp in mlps:
        for name, layer in np_params[mlp].items():
            _dense_into(state, f"{mlp}.{name}", layer, dev)
    return state


def lm_params_from_jax(np_params: dict, cfg, device=None,
                       mesh=None, train: bool = False) -> dict:
    """Reference transformer parameter pytree (numpy leaves) -> the port's
    ``Transformer`` state dict, on the card unless ``device`` says
    otherwise.  Each ``layers_{gi}`` leaf's leading (layer) axis is
    unstacked into ``layers_{gi}.{i}``; a ``kernel [in, out]`` becomes
    ``weight [out, in]`` (every dense, the MoE's ``router`` and MLA's
    ``wq_a`` ... ``wo`` included); the MoE's stacked experts ``w_gate`` /
    ``w_up`` [E, d, f] and ``w_down`` [E, f, d], the norms' ``scale``,
    ``embed`` (``table_0``, or the embedding scheme's parameters: an LMA
    pool's ``memory``), ``lm_head`` and ``final_norm`` carry over by
    name.  With a mesh, this rank's share, as ``transformer.init(...,
    mesh=)`` holds it: each expert stack's storage block
    (``nn.moe._moe_w_specs``) and the LMA pool's 'model' slab
    (``lm_rules``' ``/embed/memory$``); every other leaf whole.  With
    ``train`` as well, every leaf's ``lm_rules`` block (``sharding.
    lm_spec``), as ``transformer.init(..., mesh=, train=True)`` holds
    it."""
    from repro_torch.nn.moe import _moe_w_specs
    if train and mesh is not None:
        whole = lm_params_from_jax(np_params, cfg, "cpu")
        return {k: block(v, mesh, lm_spec(k, v.shape, mesh)).clone().to(
            resolve_device(device)) for k, v in whole.items()}
    dev = resolve_device(device)
    state = {}
    specs = {}
    if mesh is not None and cfg.moe is not None:
        sg, sd = _moe_w_specs(cfg.moe, mesh)
        specs = {"moe/w_gate": sg, "moe/w_up": sg, "moe/w_down": sd}

    def put(name: str, a) -> None:
        a = np.asarray(a)
        if name.endswith(".kernel"):
            name, a = name[:-len("kernel")] + "weight", a.T
        state[name] = _np_to_torch(a).to(dev)

    for top in ("embed", "lm_head", "final_norm"):
        for k, v in _flatten(np_params.get(top, {})).items():
            if top == "embed":
                v = rank_share(f"/embed/{k}", np.asarray(v), mesh,
                               [r for r in lm_rules() if "memory" in r[0]])
            put(f"{top}.{k.replace('/', '.')}", v)
    for gi, (_kind, count) in enumerate(cfg.layer_groups()):
        for k, v in _flatten(np_params[f"layers_{gi}"]).items():
            for i in range(count):
                a = np.asarray(v)[i]
                if k in specs:
                    a = block(a, mesh, specs[k])
                put(f"layers_{gi}.{i}.{k.replace('/', '.')}", a)
    return state


def gnn_params_from_jax(np_params: dict, cfg, device=None) -> dict:
    """Reference GAT parameter pytree (numpy leaves) -> the port's ``GAT``
    state dict, on the card unless ``device`` says otherwise:
    ``layer_{i}/{w,a_src,a_dst}`` and ``node_embed/*`` by name, the readout
    ``head/layer_{i}`` as ``nn.Linear`` (``kernel`` transposed)."""
    dev = resolve_device(device)
    state = {}
    for li in range(cfg.n_layers):
        for k, v in np_params[f"layer_{li}"].items():
            state[f"layer_{li}.{k}"] = _tensor(v, dev)
    for k, v in np_params.get("node_embed", {}).items():
        state[f"node_embed.{k}"] = _tensor(v, dev)
    for name, layer in np_params.get("head", {}).items():
        _dense_into(state, f"head.{name}", layer, dev)
    return state


def _np_to_torch(a) -> torch.Tensor:
    """A writable, contiguous copy; ml_dtypes' bfloat16 by its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def cache_from_jax(np_cache: dict, device=None) -> dict:
    """A reference decode cache (numpy leaves; ``layers_{gi}`` -> ``k``,
    ``v``, ``k_scale``, ``v_scale``, or MLA's ``ckv``, ``ckv_scale``) ->
    the port's, same layout and dtypes."""
    dev = resolve_device(device)
    return {g: {k: _np_to_torch(v).to(dev) for k, v in c.items()}
            for g, c in np_cache.items()}


def cache_to_jax(cache: dict) -> dict:
    """The port's decode cache -> numpy leaves (bf16 as float32, which
    holds every bf16 value exactly)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {g: {k: host(v) for k, v in c.items()} for g, c in cache.items()}


def _dense_into(state: dict, prefix: str, layer: dict, dev) -> None:
    state[f"{prefix}.weight"] = _tensor(np.asarray(layer["kernel"]).T, dev)
    if "bias" in layer:
        state[f"{prefix}.bias"] = _tensor(layer["bias"], dev)


def buffers_from_numpy(np_buffers: dict, device=None, mesh=None) -> dict:
    """Reference buffers (numpy) -> the port's, on the card unless
    ``device`` says otherwise: ``store_sets`` and a CSR store's
    ``store_flat`` (uint32) become int32 bit patterns (PAD = -1);
    ``store_offsets``, ``store_lengths`` and freq's ``freq_hot_ids`` stay
    int32.  With a mesh, this rank's share (``sharding.shard_buffers``):
    the dense store's rows (P must divide them), the CSR store's re-based
    part, the other buffers whole."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_buffers.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = _tensor(a, dev)
    return shard_buffers(out, mesh)


# --------------------------------------------------------- trainer states
#
# Both Trainers checkpoint {"params", "opt_state", "step"}.  A parameter's
# path differs only where a dense layer is named: the port's
# ``<layer>/weight`` [out, in] is the reference's ``<layer>/kernel``
# [in, out].  The optimizer states differ in shape of tree: a plain
# optimizer's state holds the parameter paths inside it in both packages
# (``#1/bot/layer_0/kernel`` for Adam's mu), but ``multi_transform``'s (what
# the launchers' ``make_optimizer`` builds) is a dict by parameter name in
# the port and a tuple in the reference's tree order of the parameters
# (``#k``).  Tuple indices (``#i``) never name a parameter, so an optimizer
# path splits as (tuple indices, parameter path, tuple indices).


def _split(path: str) -> tuple[list, list, list]:
    parts = path.split("/")
    lo, hi = 0, len(parts)
    while lo < hi and parts[lo].startswith("#"):
        lo += 1
    while hi > lo and parts[hi - 1].startswith("#"):
        hi -= 1
    return parts[:lo], parts[lo:hi], parts[hi:]


def _to_ref_name(parts: list) -> tuple[list, bool]:
    if parts and parts[-1] == "weight":
        return parts[:-1] + ["kernel"], True
    return parts, False


def _to_port_name(parts: list) -> tuple[list, bool]:
    if parts and parts[-1] == "kernel":
        return parts[:-1] + ["weight"], True
    return parts, False


def _t(a: np.ndarray, transpose: bool) -> np.ndarray:
    return np.ascontiguousarray(a.T) if transpose and a.ndim == 2 else a


def _convert(flat: dict, rename, multi: bool, to_ref: bool) -> dict:
    params = {k.split("/", 1)[1]: v for k, v in flat.items()
              if k.startswith("params/")}
    # the reference's tree order of its parameter paths: multi_transform's
    # tuple order
    ref_paths = sorted((tuple(_to_ref_name(p.split("/"))[0]) if to_ref
                        else tuple(p.split("/"))) for p in params)
    out = {}
    for path, v in flat.items():
        head, _, rest = path.partition("/")
        if head == "params":
            parts, tr = rename(rest.split("/"))
            out["params/" + "/".join(parts)] = _t(v, tr)
        elif head == "opt_state":
            pre, name, post = _split(rest)
            if multi and to_ref and name:
                ref, tr = _to_ref_name(name)
                new = [f"#{ref_paths.index(tuple(ref))}"] + post
            elif multi and not to_ref and len(pre) >= 1:
                port, tr = _to_port_name(list(ref_paths[int(pre[0][1:])]))
                new = port + pre[1:] + post
            else:
                parts, tr = rename(name)
                new = pre + parts + post
            out["opt_state/" + "/".join(new)] = _t(v, tr)
        else:
            out[path] = v
    return out


def state_to_jax(state: dict, multi: bool = True) -> dict:
    """The port Trainer's durable state (``Trainer._state()``, or a tree a
    port checkpoint restored) -> the reference Trainer's state tree, numpy
    leaves: dense kernels transposed and renamed, and with ``multi`` (the
    optimizer was a ``multi_transform``) the per-parameter states as the
    reference's tuple.  Adagrad's, SGD's and Adam's moments, and Adam's
    int32 step, carry across."""
    flat = {k: _host(v) for k, v in _flatten(state).items()}
    return _unflatten(_convert(flat, _to_ref_name, multi, to_ref=True))


def state_from_jax(tree: dict, multi: bool = True) -> dict:
    """The reverse of ``state_to_jax``: a reference Trainer's state tree
    (numpy leaves, e.g. what ``CheckpointManager.restore`` read from its
    checkpoint) -> the port's durable state layout, which a port
    ``CheckpointManager.save`` writes for the port's Trainer to resume."""
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    return _unflatten(_convert(flat, _to_port_name, multi, to_ref=False))
