"""Plain PyTorch version of the CIN kernel (port of
``repro/kernels/cin/ref.py::cin_ref``): the two einsums, in float32."""
from __future__ import annotations

import torch


def cin_ref(xk: torch.Tensor, x0: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """xk [B, Hk, d], x0 [B, F, d], w [Ho, Hk, F] -> [B, Ho, d]."""
    z = torch.einsum("bhd,bfd->bhfd", xk.to(torch.float32),
                     x0.to(torch.float32))
    return torch.einsum("bhfd,ohf->bod", z,
                        w.to(torch.float32)).to(xk.dtype)
