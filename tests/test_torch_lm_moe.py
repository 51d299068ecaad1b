"""The port's MoE FFN (``repro_torch.nn.moe``) against ``repro.nn.moe`` on
the CPU, in float32: the smoke configs' experts (llama4-scout's softmax
top-1 of 4 with a shared expert, deepseek-v3's sigmoid top-2 of 8 with a
shared expert), parameters crossing as numpy.

Outputs are held within 1e-5 (batched products summed in another order)
and the Switch aux loss within 1e-6.  The per-expert top-C breaks ties by
the lower token index, as ``jax.lax.top_k``: under top-1 routing every
routed weight is exactly 1.0, so an over-capacity expert keeps the tokens
the tie order picks, and the forced-overflow case holds the kept sets
equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as j_get  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402

ARCHS = ["llama4-scout-17b-a16e", "deepseek-v3-671b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch: str):
    jc = j_get(arch).make_smoke().moe
    return jc, tmoe.MoEConfig(**dataclasses.asdict(jc))


def _state(tree: dict, prefix: str = "") -> dict:
    """A reference parameter dict -> the port's state dict: ``kernel [in,
    out]`` becomes ``weight [out, in]``, the rest by name."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_state(v, f"{prefix}{k}."))
        elif k == "kernel":
            out[f"{prefix}weight"] = torch.from_numpy(np.array(v).T.copy())
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


def _pair(jc, tc, seed: int = 0):
    jp = jmoe.moe_init(jax.random.key(seed), jc)
    mod = tmoe.moe_init(tc, torch.Generator().manual_seed(seed), "cpu")
    mod.load_state_dict(_state(jp), strict=True)
    return jp, mod


_apply = jax.jit(jmoe.moe_apply, static_argnums=(1,))


@pytest.mark.parametrize("T", [1, 5, 64, 300])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches(arch, T):
    jc, tc = _cfgs(arch)
    jp, mod = _pair(jc, tc)
    x = np.random.default_rng(T).normal(size=(T, jc.d_model)).astype(
        np.float32)
    want, waux = _apply(jp, jc, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tmoe.moe_apply(mod, tc, torch.from_numpy(x))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_equal(arch):
    jc, tc = _cfgs(arch)
    for T in list(range(0, 70)) + [255, 256, 1000, 4096, 32768, 131072]:
        for cf in (1.0, 1.25, jc.n_experts / jc.top_k * 1.05):
            j = dataclasses.replace(jc, capacity_factor=cf)
            t = dataclasses.replace(tc, capacity_factor=cf)
            assert tmoe.moe_capacity(t, T) == jmoe.moe_capacity(j, T), (T, cf)


@pytest.mark.parametrize("shape,high", [((4, 300), 3), ((7, 64), 2),
                                        ((3, 1000), 1), ((2, 9), 50)])
def test_top_k_breaks_ties_as_jax(shape, high):
    """Heavily tied values (a few distinct ones, and all equal): the
    same values and indices as ``jax.lax.top_k``."""
    x = np.random.default_rng(high).integers(0, high, shape).astype(
        np.float32)
    for k in (1, shape[1] // 3, shape[1]):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tmoe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_overflow_keeps_the_same_tokens(arch):
    """The router biased so that most tokens' top-1 is expert 0, far past
    its capacity C: the same C tokens kept, in the same order, the rest
    dropped (their routed output 0), outputs within 1e-5."""
    jc, tc = _cfgs(arch)
    jp, mod = _pair(jc, tc, seed=1)
    T = 512
    kern = np.array(jp["router"]["kernel"])
    kern[0, :] = 0.0
    kern[0, 0] = 50.0                       # feature 0 pulls to expert 0
    jp["router"]["kernel"] = jnp.asarray(kern)
    mod.router.weight.data.copy_(torch.from_numpy(kern.T.copy()))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(T, jc.d_model)).astype(np.float32)
    x[:, 0] = np.where(rng.random(T) < 0.8, 1.0, -1.0)
    C = jmoe.moe_capacity(jc, T)
    R_j, _ = jmoe._route(jp["router"]["kernel"], jc, jnp.asarray(x))
    pr_j, idx_j = jax.lax.top_k(R_j.T, min(C, T))
    with torch.no_grad():
        _, top_w, top_i = tmoe.route(mod, tc, torch.from_numpy(x))
        R_t = torch.zeros((T, tc.n_experts)).scatter_(1, top_i, top_w)
        pr_t, idx_t = tmoe.top_k(R_t.T, min(C, T))
        got, aux = tmoe.moe_apply(mod, tc, torch.from_numpy(x))
    load = int((top_i == 0).sum())
    assert load > C                         # expert 0 overflows: drops
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    # the sigmoid's weights can sit an ulp apart (XLA fuses the normalizing)
    np.testing.assert_allclose(pr_t.numpy(), np.asarray(pr_j), rtol=1e-6,
                               atol=1e-6)
    assert bool((pr_t[0] > 0).all())        # expert 0 keeps C tokens
    want, waux = _apply(jp, jc, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6, atol=1e-6)
    # a token routed only to expert 0 and dropped gets the shared expert's
    # output alone
    dropped = sorted(set(np.nonzero((top_i == 0).any(-1).numpy())[0])
                     - set(idx_t[0].tolist()))
    assert dropped
    if tc.top_k == 1:
        with torch.no_grad():
            shared = mod.shared(torch.from_numpy(x[dropped]))
        np.testing.assert_allclose(got.numpy()[dropped], shared.numpy(),
                                   **TOL)


def test_bf16_experts_keep_the_reference_casts():
    """bf16 weights and tokens: the router in float32, the output in bf16,
    within bf16's rounding of the reference's (normwise 2e-2)."""
    jc, tc = _cfgs("deepseek-v3-671b")
    jp = jmoe.moe_init(jax.random.key(3), jc, dtype=jnp.bfloat16)
    mod = tmoe.moe_init(tc, torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.bfloat16)
    state = _state(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp))
    mod.load_state_dict({k: v.to(mod.state_dict()[k].dtype)
                         for k, v in state.items()}, strict=True)
    assert mod.router.weight.dtype == torch.float32
    assert mod.w_gate.dtype == torch.bfloat16
    x = np.random.default_rng(0).normal(size=(96, jc.d_model)).astype(
        np.float32)
    want, waux = _apply(jp, jc, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, aux = tmoe.moe_apply(mod, tc, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    err = np.linalg.norm(got.float().numpy() - w) / np.linalg.norm(w)
    assert err < 2e-2, err
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5, atol=1e-5)


def test_moe_dispatch_under_a_mesh():
    """Under a (1, 2) mesh of gloo ranks ``moe_dispatch`` takes
    ``moe_apply_sharded`` (each rank half the experts, a psum) and
    matches ``moe_apply`` (the same tokens and capacity: no share cuts
    them); without a mesh it is ``moe_apply``."""
    import lm_mesh_ranks as lr
    from repro_torch.dist.collectives import run_ranks
    jc, tc = _cfgs("llama4-scout-17b-a16e")
    _jp, mod = _pair(jc, tc)
    x = np.random.default_rng(2).normal(size=(4, tc.d_model)).astype(
        np.float32)
    state = {k: v.detach().numpy() for k, v in mod.state_dict().items()}
    with torch.no_grad():
        want, waux = tmoe.moe_apply(mod, tc, torch.from_numpy(x))
    for out, aux in run_ranks(lr.moe_dispatch_rank, 2, tc, state, x,
                              device="cpu"):
        np.testing.assert_allclose(out, want.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aux, float(waux), rtol=1e-6)
    zero = torch.zeros(4, tc.d_model)
    out, _ = tmoe.moe_dispatch(mod, tc, zero)
    assert torch.equal(out, tmoe.moe_apply(mod, tc, zero)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_sharded_refuses_autograd(arch):
    """The sharded MoE serves only: its collectives carry no gradient, so
    a call that autograd would record raises instead of training on wrong
    gradients; under ``no_grad`` the same call runs (a one-rank mesh: no
    collective)."""
    from repro_torch.dist.context import Mesh
    _jc, tc = _cfgs(arch)
    mod = tmoe.moe_init(tc, torch.Generator().manual_seed(0), "cpu")
    mesh = Mesh(model=1)
    x = torch.randn(8, tc.d_model, generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="no gradient"):
        tmoe.moe_apply_sharded(mod, tc, x, mesh, ("data",))
    with torch.no_grad():
        out, _ = tmoe.moe_apply_sharded(mod, tc, x, mesh, ("data",))
        want, _ = tmoe.moe_apply(mod, tc, x)
    torch.testing.assert_close(out, want, **TOL)
