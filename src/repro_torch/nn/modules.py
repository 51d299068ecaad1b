"""Dense layers, MLPs, norms and the gated FFN as ``nn.Module``s (port of
``repro.nn.modules``).

Initialization follows the reference: weights ~ N(0, 1/d_in), zero bias,
drawn from an explicit ``torch.Generator``.  A reference ``kernel [in, out]``
is this module's ``Linear.weight [out, in]`` transposed
(``repro_torch.convert``).  Submodule and parameter names (``layer_{i}``;
``scale`` and ``bias`` of the norms; ``gate``, ``up`` and ``down`` of the
FFN) mirror the reference's parameter paths.

The norms compute in the input's dtype, one reference operation at a time
(in bf16: ``mean(square(x))``, then ``rsqrt(var + eps)`` in bf16), not
through ``F.rms_norm`` / ``F.layer_norm``, which keep float32 inside.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn


def dense(d_in: int, d_out: int, generator: torch.Generator, device,
          bias: bool = True, scale: float | None = None,
          dtype: torch.dtype = torch.float32) -> nn.Linear:
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)
    layer = nn.Linear(d_in, d_out, bias=bias, device=device, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((d_out, d_in), generator=generator,
                                       device=device, dtype=dtype) * s)
        if bias:
            layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """dims[0] -> ... -> dims[-1]; ``act`` between layers, ``final_act``
    (if any) after the last."""

    def __init__(self, dims: list[int], generator: torch.Generator, device,
                 act: Callable = torch.relu,
                 final_act: Callable | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(len(dims) - 1):
            self.add_module(f"layer_{i}", dense(dims[i], dims[i + 1],
                                                generator, device,
                                                dtype=dtype))
        self.act = act
        self.final_act = final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.children())
        n = len(layers)
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < n - 1:
                x = self.act(x)
            elif self.final_act is not None:
                x = self.final_act(x)
        return x


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale``, eps 1e-6 (the reference's)."""

    def __init__(self, d: int, device, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.scale


class LayerNorm(nn.Module):
    """``(x - mu) * rsqrt(var + eps) * scale + bias``, eps 1e-5."""

    def __init__(self, d: int, device, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


class GluFFN(nn.Module):
    """SwiGLU gated FFN (LLaMA family): ``down(silu(gate(x)) * up(x))``.
    Stored for training under a mesh (``dist.tensor_parallel``), ``gate``
    and ``up`` run column-parallel over 'model' and ``down`` row-parallel,
    each weight gathered over the dp axes it is stored over."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator,
                 device, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = dense(d_model, d_ff, generator, device, bias, dtype=dtype)
        self.up = dense(d_model, d_ff, generator, device, bias, dtype=dtype)
        self.down = dense(d_ff, d_model, generator, device, bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.dist import tensor_parallel as tp
        lay = tp.layout(self.gate.weight)
        x = lay.enter(x)
        return lay.out(torch.nn.functional.silu(lay.lin(x, self.gate))
                       * lay.lin(x, self.up), self.down)


def count_params(params) -> int:
    """Elements of a module's parameters, or of a dict of tensors."""
    leaves = params.parameters() if isinstance(params, nn.Module) \
        else params.values()
    return sum(int(x.numel()) for x in leaves)
