"""Carry reference (JAX) parameters and buffers across to the port.

The two packages' random generators differ, so parameters always cross as
numpy arrays: the caller converts the reference pytree with ``np.asarray``
leaf by leaf, and these functions name and lay them out for the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import row_slab
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


def _dense_into(state: dict, prefix: str, layer: dict, dev) -> None:
    state[f"{prefix}.weight"] = _tensor(np.asarray(layer["kernel"]).T, dev)
    if "bias" in layer:
        state[f"{prefix}.bias"] = _tensor(layer["bias"], dev)


def buffers_from_numpy(np_buffers: dict, device=None, mesh=None) -> dict:
    """Reference buffers (numpy) -> the port's, on the card unless
    ``device`` says otherwise: ``store_sets`` uint32 become int32 bit
    patterns (PAD = -1); ``store_lengths`` and freq's ``freq_hot_ids``
    stay int32.  With a mesh, this rank's rows of each (P must divide
    them)."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_buffers.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = row_slab(_tensor(a, dev), mesh)
    return out
