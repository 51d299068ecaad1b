"""Port CIN module (CPU path) vs the JAX package: the Pallas kernel in
interpret mode (``repro.kernels.cin.ops.cin``), its plain reference
``cin_ref`` and the model's ``cin_layer``; the gradient against ``jax.grad``
of ``cin_layer``; ``params_from_jax`` for xDeepFM.

Tolerance: every output (and every gradient entry) within 1e-5 of the sum
of the absolute values of its terms, the scale that float32 rounding of a
sum in another order is proportional to."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.kernels.cin.ops import cin as jcin  # noqa: E402
from repro.kernels.cin.ref import cin_ref as jcin_ref  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.cin import ops  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402

RTOL_ABS = 1e-5      # of each entry's sum |terms|


def _inputs(B, Hk, F, d, Ho, seed):
    rng = np.random.default_rng(seed)
    xk = rng.normal(0, 1, (B, Hk, d)).astype(np.float32)
    x0 = rng.normal(0, 1, (B, F, d)).astype(np.float32)
    w = (rng.normal(0, 1, (Ho, Hk, F)) / np.sqrt(Hk * F)).astype(np.float32)
    return xk, x0, w


def _abs_terms(xk, x0, w) -> np.ndarray:
    """sum_{h,f} |w[o,h,f] xk[b,h,e] x0[b,f,e]| for every output."""
    return np.einsum("bhd,bfd,ohf->bod", np.abs(xk).astype(np.float64),
                     np.abs(x0), np.abs(w))


def _within(got, want, scale, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    ratio = float((err / np.maximum(scale, 1e-30)).max())
    print(f"{what}: max |err| {err.max():.3g}, max |err| / sum|terms| "
          f"{ratio:.3g}")
    assert ratio <= RTOL_ABS, f"{what}: {ratio:.3g} > {RTOL_ABS}"


# the shapes of tests/test_kernels.py::test_cin_sweep, a ragged batch (no
# multiple of the reference's 32-sample block) and the later layers' Hk != F
@pytest.mark.parametrize("B,Hk,F,d,Ho", [
    (32, 39, 39, 10, 200), (64, 24, 12, 8, 24), (16, 8, 8, 4, 16),
    (13, 39, 39, 10, 24), (8, 200, 39, 10, 24)])
def test_cin_matches_pallas_ref_and_model_layer(B, Hk, F, d, Ho):
    xk, x0, w = _inputs(B, Hk, F, d, Ho, seed=B + Hk)
    got = ops.cin(torch.from_numpy(xk), torch.from_numpy(x0),
                  torch.from_numpy(w)).numpy()
    assert got.shape == (B, Ho, d) and got.dtype == np.float32
    scale = _abs_terms(xk, x0, w)
    jx = [jnp.asarray(a) for a in (xk, x0, w)]
    _within(got, jcin(*jx, True), scale, "vs Pallas interpret")
    _within(got, jcin_ref(*jx), scale, "vs cin_ref")
    _within(got, jrec.cin_layer(jx[2], jx[0], jx[1]), scale, "vs cin_layer")


def _port_grads(xk, x0, w, g):
    t = [torch.from_numpy(a).requires_grad_() for a in (xk, x0, w)]
    ops.cin(*t).backward(torch.from_numpy(g))
    return [a.grad.numpy() for a in t]


@pytest.mark.parametrize("B,Hk,F,d,Ho", [(16, 39, 39, 10, 24),
                                         (7, 24, 12, 8, 16)])
def test_cin_gradients_match_jax_grad(B, Hk, F, d, Ho):
    xk, x0, w = _inputs(B, Hk, F, d, Ho, seed=3 * B)
    g = np.random.default_rng(B).normal(0, 1, (B, Ho, d)).astype(np.float32)

    def loss(xk_, x0_, w_):
        return jnp.sum(jrec.cin_layer(w_, xk_, x0_) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (xk, x0, w)))
    got = _port_grads(xk, x0, w, g)
    # each gradient entry's sum |terms|: the same gradient of |inputs|
    scale = _port_grads(*(np.abs(a) for a in (xk, x0, w, g)))
    for name, gt, wt, sc in zip(("dxk", "dx0", "dw"), got, want, scale):
        assert gt.shape == wt.shape
        _within(gt, wt, sc.astype(np.float64), name)


def test_cin_rejects_other_devices():
    x = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError):
        ops.cin(x, x, torch.zeros((5, 3, 3), device="meta"))


def test_params_from_jax_xdeepfm():
    """CIN weights copy as [Ho, Hk, F]; cin_out and the deep MLP kernels are
    transposed; both pools copy."""
    jcfg, tcfg = jget("xdeepfm").make_smoke(), tget("xdeepfm").make_smoke()
    jp = jax.tree_util.tree_map(np.asarray, jrec.init(jax.random.key(2),
                                                      jcfg))
    state = params_from_jax(jp, tcfg, device="cpu")
    model = trec.init(tcfg, device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    np.testing.assert_array_equal(state["embedding.memory"].numpy(),
                                  jp["embedding"]["memory"])
    np.testing.assert_array_equal(state["linear.memory"].numpy(),
                                  jp["linear"]["memory"])
    for i in range(len(tcfg.cin_layers)):
        np.testing.assert_array_equal(state[f"cin.layer_{i}"].numpy(),
                                      jp["cin"][f"layer_{i}"])
    np.testing.assert_array_equal(state["cin_out.weight"].numpy(),
                                  jp["cin_out"]["kernel"].T)
    np.testing.assert_array_equal(state["cin_out.bias"].numpy(),
                                  jp["cin_out"]["bias"])
    for name, layer in jp["deep"].items():
        np.testing.assert_array_equal(state[f"deep.{name}.weight"].numpy(),
                                      layer["kernel"].T)
    assert tuple(state["cin.layer_1"].shape) == (24, 24, 12)


# ------------------------------ the 3xTF32 split of csrc/cin.cu, emulated

def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits cleared)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tensor_core_cin(xk, x0, w, passes: int) -> np.ndarray:
    """The kernel's arithmetic: Z = xk * x0 rounded to float32, Z and W each
    split into big = tf32(x) and small = tf32(x - big), and each k8 step
    (one h, eight f; f-blocks outer, h inner, as the kernel walks Q) adds
    small*big, then big*small, then big*big to a float32 accumulator (the
    TF32 products are exact; each step's sum is rounded once).  passes=1
    keeps big*big alone, a plain TF32 product."""
    B, Hk, d = xk.shape
    F, Ho = x0.shape[1], w.shape[0]
    z = (xk[:, :, None, :] * x0[:, None, :, :]).astype(np.float32)
    z = z.transpose(0, 3, 1, 2).reshape(B * d, Hk * F)        # [N, Q]
    wq = w.reshape(Ho, Hk * F).T.astype(np.float32)            # [Q, Ho]
    zb, wb = _tf32(z), _tf32(wq)
    zs, ws = _tf32(z - zb), _tf32(wq - wb)
    parts = [(zs, wb), (zb, ws), (zb, wb)][3 - passes:]
    acc = np.zeros((B * d, Ho), np.float32)
    for f0 in range(0, F, 8):
        for h in range(Hk):
            q = slice(h * F + f0, h * F + min(f0 + 8, F))
            for a, b in parts:
                step = a[:, q].astype(np.float64) @ b[q].astype(np.float64)
                acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc.reshape(B, d, Ho).transpose(0, 2, 1)


@pytest.mark.parametrize("Hk", [39, 200])
def test_three_tf32_passes_keep_float32_accuracy(Hk):
    """At xDeepFM's F = 39, d = 10, Ho = 200 (Q = 1,521 and 7,800), the
    3xTF32 product stays within 1e-5 of each output's sum |terms| of the
    float64 einsum, and well inside one TF32 pass's error."""
    xk, x0, w = _inputs(3, Hk, 39, 10, 200, Hk)
    exact = np.einsum("bhd,bfd,ohf->bod", xk.astype(np.float64),
                      x0.astype(np.float64), w.astype(np.float64))
    scale = _abs_terms(xk, x0, w)
    err3 = np.abs(_tensor_core_cin(xk, x0, w, 3) - exact) / scale
    err1 = np.abs(_tensor_core_cin(xk, x0, w, 1) - exact) / scale
    assert err3.max() <= RTOL_ABS
    assert err3.max() * 10 < err1.max()
