"""The port's attention (``repro_torch.nn.attention``) against
``repro.nn.attention`` on the CPU: RoPE, int8 KV quantization, the blocked
online softmax, GQA's train and decode paths, and the norms and gated FFN
they sit between (``repro_torch.nn.modules``).

RoPE's table is held within 1e-6, not bitwise: XLA's and PyTorch's float32
``cos`` differ by an ulp at some angles.  Quantization is bit-identical.
Attention is held within 1e-6 relative in float32 (sums in another order);
GQA's projections add float32 matmuls, held within 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.nn import attention as ja  # noqa: E402
from repro.nn import modules as jm  # noqa: E402
from repro_torch.nn import attention as ta  # noqa: E402
from repro_torch.nn import modules as tm  # noqa: E402


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("theta,dim", [(1e4, 64), (1e6, 128), (1e4, 16)])
def test_rope_table_and_apply(theta, dim):
    pos = np.arange(0, 32768, 97, dtype=np.int32)
    jc, js = ja.rope_table(jnp.asarray(pos), dim, theta)
    tc, ts = ta.rope_table(_t(pos), dim, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    x = np.random.default_rng(0).normal(size=(2, pos.size, 3, dim)).astype(
        np.float32)
    # the same table on both sides: apply_rope itself is elementwise
    want = ja.apply_rope(jnp.asarray(x), jnp.asarray(tc.numpy()),
                         jnp.asarray(ts.numpy()))
    got = ta.apply_rope(_t(x), tc, ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [3.0, 1e-3])
def test_quantize_dequantize_bit_identical(scale):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 9, 4, 32)) * scale).astype(np.float32)
    x[0, :2] = 0.0                                  # zero rows
    x[1, 3, 1] = -0.0
    jq, js = ja.quantize_kv(jnp.asarray(x))
    tq, ts = ta.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back_j = ja.dequantize_kv(jq, js, jnp.float32)
    back_t = ta.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def _attn_inputs(rng, B, S, T, H, KV, hd):
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    return q, k, v


def _close(got: torch.Tensor, want, rtol=1e-6):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * max(scale, 1.0))


@pytest.mark.parametrize("G,S,block,q_block", [
    (1, 64, 16, 32), (2, 50, 16, 24), (8, 37, 8, 16), (2, 64, 8, 64)])
def test_blocked_attention_causal_aligned(G, S, block, q_block):
    rng = np.random.default_rng(S * 10 + G)
    KV = 2
    q, k, v = _attn_inputs(rng, 2, S, S, KV * G, KV, 16)
    pos = np.arange(S, dtype=np.int32)
    want = ja.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, q_positions=jnp.asarray(pos),
                                kv_positions=jnp.asarray(pos), block=block,
                                q_block=q_block)
    got = ta.blocked_attention(_t(q), _t(k), _t(v), causal=True,
                               q_positions=_t(pos), kv_positions=_t(pos),
                               block=block, q_block=q_block)
    _close(got, want)


@pytest.mark.parametrize("G,valid", [(1, "scalar"), (8, "per_batch"),
                                     (2, None)])
def test_blocked_attention_noncausal_valid_len(G, valid):
    rng = np.random.default_rng(7 + G)
    B, S, T, KV = 3, 5, 45, 2                     # T not a multiple of block
    q, k, v = _attn_inputs(rng, B, S, T, KV * G, KV, 16)
    qpos = np.arange(T - S, T, dtype=np.int32)
    kpos = np.arange(T, dtype=np.int32)
    vl = {"scalar": 31, "per_batch": np.array([45, 20, 1], np.int32),
          None: None}[valid]
    want = ja.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        kv_valid_len=None if vl is None else jnp.asarray(vl), block=16)
    got = ta.blocked_attention(
        _t(q), _t(k), _t(v), causal=False, q_positions=_t(qpos),
        kv_positions=_t(kpos),
        kv_valid_len=None if vl is None else _t(vl), block=16)
    _close(got, want)


def _gqa_pair(rng, cfg):
    jp = ja.gqa_init(jax.random.key(3), cfg)
    tcfg = ta.GQAConfig(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.qkv_bias, cfg.rope_theta)
    mod = ta.gqa_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            layer = getattr(mod, name)
            layer.weight.copy_(_t(np.asarray(jp[name]["kernel"]).T))
            if layer.bias is not None:
                b = rng.normal(size=layer.bias.shape).astype(np.float32)
                jp[name]["bias"] = jnp.asarray(b)
                layer.bias.copy_(_t(b))
    return jp, mod, tcfg


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("H,KV", [(8, 2), (4, 4)])
def test_gqa_train_matches(bias, H, KV):
    rng = np.random.default_rng(H + KV)
    cfg = ja.GQAConfig(64, H, KV, None, bias, 1e4)
    jp, mod, tcfg = _gqa_pair(rng, cfg)
    x = rng.normal(size=(2, 37, 64)).astype(np.float32)
    want, wkv = ja.gqa_train(jp, cfg, jnp.asarray(x), block=16,
                             return_kv=True)
    with torch.no_grad():
        got, gkv = ta.gqa_train(mod, tcfg, _t(x), block=16, return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(gkv[name].numpy(), np.asarray(wkv[name]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_gqa_decode_matches(quant):
    rng = np.random.default_rng(11)
    cfg = ja.GQAConfig(64, 8, 2, None, False, 1e4)
    jp, mod, tcfg = _gqa_pair(rng, cfg)
    B, L, n = 2, 40, 23
    k = rng.normal(size=(B, L, 2, 8)).astype(np.float32)
    v = rng.normal(size=(B, L, 2, 8)).astype(np.float32)
    k[:, n:] = 0.0
    v[:, n:] = 0.0
    if quant:
        kq, ks = ja.quantize_kv(jnp.asarray(k))
        vq, vs = ja.quantize_kv(jnp.asarray(v))
        jcache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tcache = {name: _t(np.asarray(a)) for name, a in jcache.items()}
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    want, wc = ja.gqa_decode(jp, cfg, jnp.asarray(x), jcache,
                             jnp.asarray(n, jnp.int32), block=16)
    with torch.no_grad():
        got, gc = ta.gqa_decode(mod, tcfg, _t(x), tcache, n, block=16)
    assert gc is tcache                             # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name in jcache:
        g, w = gc[name].numpy(), np.asarray(wc[name])
        np.testing.assert_array_equal(g[:, :n], w[:, :n])
        np.testing.assert_array_equal(g[:, n + 1:], w[:, n + 1:])
        if quant and name in ("k", "v"):
            # the new row, quantized from K / V that differ by rounding:
            # equal, or one int8 step apart
            assert np.abs(g[:, n].astype(np.int32)
                          - w[:, n].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g[:, n], w[:, n], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 5, 48)) * 4).astype(np.float32)
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    if kind == "rmsnorm":
        want = jm.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
        mod = tm.RMSNorm(48, "cpu")
    else:
        want = jm.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jnp.asarray(x))
        mod = tm.LayerNorm(48, "cpu")
        mod.bias.data.copy_(_t(bias))
    mod.scale.data.copy_(_t(scale))
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_glu_ffn_and_count_params():
    rng = np.random.default_rng(4)
    jp = jm.glu_ffn_init(jax.random.key(5), 32, 80)
    mod = tm.GluFFN(32, 80, torch.Generator().manual_seed(0), "cpu")
    for name in ("gate", "up", "down"):
        getattr(mod, name).weight.data.copy_(
            _t(np.asarray(jp[name]["kernel"]).T))
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(),
                               np.asarray(jm.glu_ffn(jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    assert tm.count_params(mod) == jm.count_params(jp)


def test_mla_and_mesh_decode_run():
    """Under a mesh the decode takes ``dist.flash_decode`` and the MoE
    ``moe_apply_sharded``: GQA's and MLA's decode (the length over a
    'model' axis of 2, on 2 gloo ranks) and the MoE dispatch run, and
    match the one-card path: outputs within 1e-5, each rank's cache slab
    equal to the one-card cache's rows."""
    import lm_mesh_ranks as lr
    from repro_torch.dist.collectives import run_ranks
    one = lr.decode_pieces(None)
    ranks = run_ranks(lr.decode_pieces, 2, device="cpu")
    assert [r["pos"] for r in ranks] == [(0, 2), (2, 4)]
    for r in ranks:
        for name in ("gqa", "mla", "moe"):
            np.testing.assert_allclose(r[name], one[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(r["aux"], one["aux"], rtol=1e-6)
        lo, hi = r["pos"]
        np.testing.assert_array_equal(r["k"], one["k"][:, lo:hi])
        np.testing.assert_array_equal(r["ckv"], one["ckv"][:, lo:hi])
    # without a mesh each runs
    rng = np.random.default_rng(0)
    cfg = ja.GQAConfig(64, 8, 2, None, False, 1e4)
    _jp, mod, tcfg = _gqa_pair(rng, cfg)
    cache = {"k": torch.zeros(1, 4, 2, 8), "v": torch.zeros(1, 4, 2, 8)}
    ta.gqa_decode(mod, tcfg, torch.zeros(1, 1, 64), cache, 0)


@pytest.mark.parametrize("quant", [False, True])
def test_gqa_decode_clamps_a_full_cache(quant):
    """At ``cache_len = L`` the write clamps to row L - 1 and the query
    attends every row, as the reference's ``dynamic_update_slice``."""
    rng = np.random.default_rng(7)
    cfg = ja.GQAConfig(64, 8, 2, None, False, 1e4)
    jp, mod, tcfg = _gqa_pair(rng, cfg)
    B, L = 2, 6
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    k = rng.normal(size=(B, L, 2, 8)).astype(np.float32)
    v = rng.normal(size=(B, L, 2, 8)).astype(np.float32)
    if quant:
        (kq, ks), (vq, vs) = ja.quantize_kv(jnp.asarray(k)), \
            ja.quantize_kv(jnp.asarray(v))
        jc = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: _t(np.array(a)) for n, a in jc.items()}
    want, wc = ja.gqa_decode(jp, cfg, jnp.asarray(x), jc,
                             jnp.asarray(L, jnp.int32), block=4)
    with torch.no_grad():
        got, gc = ta.gqa_decode(mod, tcfg, _t(x), tc, L, block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for n, w in wc.items():
        w, g = np.asarray(w), gc[n].numpy()
        np.testing.assert_array_equal(g[:, :L - 1], w[:, :L - 1])
        if quant and n in ("k", "v"):
            assert np.abs(g[:, L - 1].astype(np.int32)
                          - w[:, L - 1].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g[:, L - 1], w[:, L - 1], rtol=1e-5,
                                       atol=1e-5)
        assert not np.array_equal(g[:, L - 1], np.array(jc[n])[:, L - 1])