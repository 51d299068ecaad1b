"""The port's MLA attention (``repro_torch.nn.attention``'s ``mla_*``)
against ``repro.nn.attention`` on the CPU, in float32, parameters crossing
as numpy: ``mla_train`` (a low-rank query, ``q_lora_rank`` > 0, and a
direct one, = 0) with its fused latent ``ckv``, within 1e-5; the absorbed
``mla_decode`` from the reference's own prefill cache (``cache_from_jax``),
float within 1e-5, int8 equal or one int8 step apart (a latent that differs
by rounding can round to the neighbouring step), the written cache row
included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as j_get  # noqa: E402
from repro.nn import attention as ja  # noqa: E402
from repro_torch.convert import cache_from_jax  # noqa: E402
from repro_torch.nn import attention as ta  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SMOKE = j_get("deepseek-v3-671b").make_smoke().mla     # H 4, r 16, rd 8
CFGS = {"q_lora": SMOKE,
        "direct_q": dataclasses.replace(SMOKE, q_lora_rank=0),
        "wide": ja.MLAConfig(d_model=96, n_heads=6, q_lora_rank=24,
                             kv_lora_rank=32, qk_nope_dim=8, qk_rope_dim=16,
                             v_head_dim=12, rope_theta=5e5)}


def _state(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_state(v, f"{prefix}{k}."))
        elif k == "kernel":
            out[f"{prefix}weight"] = torch.from_numpy(np.array(v).T.copy())
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


def _pair(name: str, seed: int = 0):
    jc = CFGS[name]
    tc = ta.MLAConfig(**dataclasses.asdict(jc))
    jp = ja.mla_init(jax.random.key(seed), jc)
    mod = ta.mla_init(tc, torch.Generator().manual_seed(seed), "cpu")
    mod.load_state_dict(_state(jp), strict=True)
    names = {n for n, _ in mod.named_parameters()}
    q = {"wq.weight"} if jc.q_lora_rank == 0 else \
        {"wq_a.weight", "q_norm.scale", "wq_b.weight"}
    assert names == q | {"wkv_a.weight", "kv_norm.scale", "wkv_b.weight",
                         "wo.weight"}
    return jc, tc, jp, mod


_train = jax.jit(ja.mla_train, static_argnums=(1,),
                 static_argnames=("block", "return_kv"))
_decode = jax.jit(ja.mla_decode, static_argnums=(1,),
                  static_argnames=("block",))


@pytest.mark.parametrize("S,block", [(16, 16), (37, 8), (5, 16)])
@pytest.mark.parametrize("name", list(CFGS))
def test_mla_train_and_latent_match(name, S, block):
    jc, tc, jp, mod = _pair(name)
    x = np.random.default_rng(S).normal(size=(2, S, jc.d_model)).astype(
        np.float32)
    want, wkv = _train(jp, jc, jnp.asarray(x), block=block, return_kv=True)
    with torch.no_grad():
        got, gkv = ta.mla_train(mod, tc, torch.from_numpy(x), block=block,
                                return_kv=True)
        plain = ta.mla_train(mod, tc, torch.from_numpy(x), block=block)
    assert torch.equal(plain, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(gkv["ckv"].shape) == (2, S, jc.kv_lora_rank
                                       + jc.qk_rope_dim)
    np.testing.assert_allclose(gkv["ckv"].numpy(), np.asarray(wkv["ckv"]),
                               **TOL)


def _prefix_cache(jc, jp, x, n: int, L: int, quant: bool) -> dict:
    """The reference's cache of x[:, :n] (mla_train's latents, quantized
    for int8), grown to L rows."""
    _, kv = _train(jp, jc, jnp.asarray(x[:, :n]), block=16, return_kv=True)
    ckv = jnp.pad(kv["ckv"], [(0, 0), (0, L - n), (0, 0)])
    if not quant:
        return {"ckv": ckv}
    q, s = ja.quantize_kv(ckv)
    return {"ckv": q, "ckv_scale": s}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("name", list(CFGS))
def test_mla_decode_matches(name, quant):
    jc, tc, jp, mod = _pair(name, seed=1)
    B, L, n = 2, 40, 23
    x = np.random.default_rng(5).normal(size=(B, n + 1, jc.d_model)).astype(
        np.float32)
    jcache = _prefix_cache(jc, jp, x, n, L, quant)
    tcache = cache_from_jax({"layer": jax.tree_util.tree_map(
        np.asarray, jcache)}, "cpu")["layer"]
    want, wc = _decode(jp, jc, jnp.asarray(x[:, n:]), jcache,
                       jnp.asarray(n, jnp.int32), block=16)
    with torch.no_grad():
        got, gc = ta.mla_decode(mod, tc, torch.from_numpy(x[:, n:]), tcache,
                                n, block=16)
    assert gc is tcache                             # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name_, w in wc.items():
        g, w = gc[name_].numpy(), np.asarray(w)
        np.testing.assert_array_equal(g[:, :n], w[:, :n])
        np.testing.assert_array_equal(g[:, n + 1:], w[:, n + 1:])
        if quant and name_ == "ckv":
            assert np.abs(g[:, n].astype(np.int32)
                          - w[:, n].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g[:, n], w[:, n], **TOL)
    assert gc["ckv"][:, n].abs().sum() > 0


def test_absorbed_decode_equals_the_expanded_attention():
    """On the port alone: the absorbed decode at position n against
    ``mla_train``'s last position over the same n + 1 tokens (float
    cache), within 1e-5."""
    jc, tc, jp, mod = _pair("wide", seed=2)
    B, n = 3, 19
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, n + 1, jc.d_model)).astype(np.float32))
    with torch.no_grad():
        full, kv = ta.mla_train(mod, tc, x, block=8, return_kv=True)
        cache = {"ckv": torch.zeros(B, n + 4, kv["ckv"].shape[-1])}
        cache["ckv"][:, :n] = kv["ckv"][:, :n]
        dec, _ = ta.mla_decode(mod, tc, x[:, n:], cache, n, block=8)
    torch.testing.assert_close(dec, full[:, n:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cache["ckv"][:, n], kv["ckv"][:, n],
                               rtol=1e-5, atol=1e-5)


def test_mla_decode_rejects_a_full_cache():
    """A full cache is not rejected: at ``cache_len = L`` the latent is
    written to row L - 1 and every row is attended, as the reference's
    ``dynamic_update_slice`` clamps (and its sharded decode after it)."""
    jc, tc, jp, mod = _pair("q_lora")
    B, L = 2, 4
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
    lat = rng.normal(size=(B, L, tc.kv_lora_rank + tc.qk_rope_dim)).astype(
        np.float32)
    want, wc = _decode(jp, jc, jnp.asarray(x), {"ckv": jnp.asarray(lat)},
                       jnp.asarray(L, jnp.int32), block=16)
    cache = {"ckv": torch.from_numpy(lat.copy())}
    with torch.no_grad():
        got, gc = ta.mla_decode(mod, tc, torch.from_numpy(x), cache, L,
                                block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    g, w = gc["ckv"].numpy(), np.asarray(wc["ckv"])
    np.testing.assert_array_equal(g[:, :L - 1], lat[:, :L - 1])
    np.testing.assert_allclose(g[:, L - 1], w[:, L - 1], **TOL)
    assert not np.array_equal(g[:, L - 1], lat[:, L - 1])
