"""Public wrapper with its gradient: the CUDA kernel forward for CUDA
tensors, the plain version for CPU tensors, a raise for anything else.

The backward is plain PyTorch on both devices.  With rows r = (b, e) and
columns q = (h, f), Z[r, q] = xk[b, h, e] * x0[b, f, e] and G[r, o] =
g[b, o, e] (g the output's cotangent), it is two matrix products and two
batched matrix-vector products:
  dW = G^T Z                      [Ho, Hk*F]
  dZ = G W                        [B*d, Hk*F]
  dxk[b, h, e] = sum_f dZ[r, h, f] x0[b, f, e]
  dx0[b, f, e] = sum_h dZ[r, h, f] xk[b, h, e]
Z and dZ are built row-major in (b, e), so no product needs its operand
copied into another layout; each is [B*d, Hk*F] float32, 1.28 GB at
xDeepFM's Hk = 200, F = 39, d = 10 and B = 4,096.  The reference has no
backward kernel to port here (its xDeepFM computes the layer with
``jnp.einsum``, whose gradient XLA derives outside any Pallas kernel)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cin.kernel import cin_cuda
from repro_torch.kernels.cin.ref import cin_ref


class _CIN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xk, x0, w):
        ctx.save_for_backward(xk, x0, w)
        if xk.is_cuda:
            return cin_cuda(xk, x0, w)
        return cin_ref(xk, x0, w)

    @staticmethod
    def backward(ctx, g):
        xk, x0, w = ctx.saved_tensors
        B, Hk, d = xk.shape
        F, Ho = x0.shape[1], w.shape[0]
        need_xk, need_x0, need_w = ctx.needs_input_grad
        g2 = g.permute(0, 2, 1).reshape(B * d, Ho)                  # G
        xkt, x0t = xk.transpose(1, 2), x0.transpose(1, 2)           # [B, d, *]
        dxk = dx0 = dw = None
        if need_w:
            z = (xkt[..., :, None] * x0t[..., None, :]).reshape(B * d,
                                                                Hk * F)
            dw = (g2.t() @ z).reshape(Ho, Hk, F)
            del z
        if need_xk or need_x0:
            dz = (g2 @ w.reshape(Ho, Hk * F)).reshape(B * d, Hk, F)
            if need_xk:
                dxk = torch.bmm(dz, x0t.reshape(B * d, F, 1)).reshape(
                    B, d, Hk).transpose(1, 2)
            if need_x0:
                dx0 = torch.bmm(dz.transpose(1, 2),
                                xkt.reshape(B * d, Hk, 1)).reshape(
                    B, d, F).transpose(1, 2)
        return dxk, dx0, dw


def cin(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One CIN layer: xk [B, Hk, d], x0 [B, F, d], w [Ho, Hk, F] ->
    [B, Ho, d], ``out[b, o, e] = sum_{h, f} w[o, h, f] xk[b, h, e]
    x0[b, f, e]``."""
    if not xk.is_cuda and xk.device.type != "cpu":
        raise ValueError(f"cin: unsupported device {xk.device}")
    return _CIN.apply(xk, x0, w)
