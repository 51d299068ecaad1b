"""Carry reference (JAX) parameters and buffers across to the port.

The two packages' random generators differ, so parameters always cross as
numpy arrays: the caller converts the reference pytree with ``np.asarray``
leaf by leaf, and these functions name and lay them out for the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys import RecsysConfig


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)   # a writable, contiguous copy


def params_from_jax(np_params: dict, cfg: RecsysConfig, device=None) -> dict:
    """Reference DLRM parameter pytree (numpy leaves) -> the port's
    ``Recsys`` state dict, on the card unless ``device`` says otherwise.

    The embedding parameters copy straight across (``memory``,
    ``table_{t}``); a dense ``kernel [in, out]`` becomes
    ``Linear.weight [out, in]`` (transposed) and ``bias`` copies."""
    if cfg.model != "dlrm":
        raise NotImplementedError(cfg.model)
    dev = resolve_device(device)
    state = {f"embedding.{k}": _tensor(v, dev)
             for k, v in np_params["embedding"].items()}
    for mlp in ("bot", "top"):
        for name, layer in np_params[mlp].items():
            state[f"{mlp}.{name}.weight"] = _tensor(
                np.asarray(layer["kernel"]).T, dev)
            if "bias" in layer:
                state[f"{mlp}.{name}.bias"] = _tensor(layer["bias"], dev)
    return state


def buffers_from_numpy(np_buffers: dict, device=None) -> dict:
    """Reference buffers (numpy) -> the port's, on the card unless
    ``device`` says otherwise: ``store_sets`` uint32 become int32 bit
    patterns (PAD = -1), ``store_lengths`` stay int32."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_buffers.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = _tensor(a, dev)
    return out
