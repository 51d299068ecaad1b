"""Dense layers and MLPs as ``nn.Module``s (port of ``repro.nn.modules``).

Initialization follows the reference: weights ~ N(0, 1/d_in), zero bias,
drawn from an explicit ``torch.Generator``.  A reference ``kernel [in, out]``
is this module's ``Linear.weight [out, in]`` transposed
(``repro_torch.convert``).  Submodule names (``layer_{i}``) mirror the
reference's parameter paths.
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
