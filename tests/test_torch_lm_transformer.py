"""The port's transformer LM (``repro_torch.models.transformer``) against
``repro.models.transformer`` on the CPU, at the smoke configs of
tinyllama-1.1b (RMSNorm, GQA), stablelm-3b (LayerNorm), qwen1.5-32b (QKV
bias), deepseek-v3-671b (MLA, a dense layer then sigmoid top-2 MoE layers
with a shared expert) and llama4-scout-17b-a16e (GQA, softmax top-1 MoE
layers): parameters cross as numpy (``lm_params_from_jax``, strict), the
MoE at the configs' own capacity factor, drops included; outputs are held
within 1e-5 in float32 (matmuls and sums in another order), an int8 cache
equal or one int8 step apart (a K or V that differs by rounding can round
to the neighbouring step), bf16 with an int8 cache within the reference's
own int8 bound (``tests/test_kv_quant.py``: rtol 0.1, atol 0.15), and an
LMA token table's lookup bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs._recsys_common import embedding_of_kind as j_emb  # noqa: E402
from repro.configs.base import get_config as j_get  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs._recsys_common import \
    embedding_of_kind as t_emb  # noqa: E402
from repro_torch.convert import (buffers_from_numpy, cache_from_jax,  # noqa: E402
                                 cache_to_jax, lm_params_from_jax)
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ["tinyllama-1.1b", "stablelm-3b", "qwen1.5-32b", "deepseek-v3-671b",
         "llama4-scout-17b-a16e"]
B, S = 2, 16
TOL = dict(rtol=1e-5, atol=1e-5)


class _Jitted:
    """The reference's functions jitted, the config static: one compile a
    config and shape, where eager JAX compiles op by op (seconds a call of
    a MoE config)."""

    def __getattr__(self, name):
        fn = jax.jit(getattr(jt, name), static_argnums=(1,))
        setattr(self, name, fn)
        return fn


jj = _Jitted()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jinit(jcfg, seed: int) -> dict:
    """Parameters in the reference's tree (``jax.eval_shape`` of its
    init), drawn by numpy as its init scales them: norms' ``scale`` 1,
    ``bias`` 0, the token table and pool N(0, 1/d), every other leaf N(0,
    1/fan_in) over its next-to-last axis (a kernel's input, a stacked
    expert's d or f).  jax.random's init compiles for seconds a MoE
    config."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jt.init(jax.random.key(0), jcfg))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            a = np.ones(s.shape)
        elif name.endswith("['bias']"):
            a = np.zeros(s.shape)
        else:
            n = jcfg.d_model if name.startswith("['embed']") \
                else s.shape[-2]
            a = rng.normal(size=s.shape) / np.sqrt(n)
        return jnp.asarray(a.astype(np.float32)).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(jcfg, tcfg, seed=0):
    params = _jinit(jcfg, seed)
    model = tt.init(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(_np(params), tcfg, "cpu"))
    return params, model


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = j_get(request.param).make_smoke()
    tcfg = t_get(request.param).make_smoke()
    params, model = _pair(jcfg, tcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, params=params,
                model=model, tokens=tokens, labels=labels)


def _fields(x):
    """A config field's value; a nested config (MLA, MoE) as its dict."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_config_fields_and_param_count(arch):
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    for f in dataclasses.fields(tt.TransformerConfig):
        assert _fields(getattr(tcfg, f.name)) == \
            _fields(getattr(jcfg, f.name)), f.name
    assert tcfg.layer_groups() == jcfg.layer_groups()
    full_j = j_get(arch["name"]).make_model()
    full_t = t_get(arch["name"]).make_model()
    assert tt.param_count(full_t) == jt.param_count(full_j)
    assert tt.param_count(tcfg) == jt.param_count(jcfg)
    from repro.nn.modules import count_params as j_count
    from repro_torch.nn.modules import count_params
    assert count_params(arch["model"]) == j_count(arch["params"])


def test_forward_logits_loss(arch):
    jcfg, tcfg, params, model = (arch[k] for k in ("jcfg", "tcfg", "params",
                                                   "model"))
    tok, lab = arch["tokens"], arch["labels"]
    hj, auxj = jj.forward(params, jcfg, jnp.asarray(tok))
    with torch.no_grad():
        ht, aux = tt.forward(model, tcfg, torch.from_numpy(tok))
        lt = tt.logits_fn(model, tcfg, ht)
    if jcfg.moe is None:
        assert float(aux) == 0.0
    else:                           # the MoE layers' Switch loss, summed
        assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(lt.numpy(),
                               np.asarray(jj.logits_fn(params, jcfg, hj)),
                               **TOL)
    for chunk in (0, 8):
        jc = dataclasses.replace(jcfg, loss_chunk=chunk)
        tc = dataclasses.replace(tcfg, loss_chunk=chunk)
        want, wm = jj.loss_fn(params, jc, jnp.asarray(tok), jnp.asarray(lab))
        with torch.no_grad():
            got, gm = tt.loss_fn(model, tc, torch.from_numpy(tok),
                                 torch.from_numpy(lab))
        np.testing.assert_allclose(float(got), float(want), **TOL)
        np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **TOL)
        np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), **TOL)


def _int8_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in got:
        if name.endswith("_scale"):
            np.testing.assert_allclose(got[name], want[name], **TOL)
        else:
            diff = np.abs(got[name].astype(np.int32)
                          - want[name].astype(np.int32))
            assert diff.max() <= 1, name


def _float_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_and_decode(arch, quant):
    jcfg = dataclasses.replace(arch["jcfg"],
                               kv_cache_dtype="int8" if quant else None)
    tcfg = dataclasses.replace(arch["tcfg"],
                               kv_cache_dtype="int8" if quant else None)
    params, model, tok = arch["params"], arch["model"], arch["tokens"]
    n = S - 1
    lj, cj = jj.prefill(params, jcfg, jnp.asarray(tok[:, :n]))
    lt, ct = tt.prefill(model, tcfg, torch.from_numpy(tok[:, :n]))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    close = _int8_close if quant else _float_close
    for g in cj:                    # every layer group
        close(cache_to_jax(ct)[g], _np(cj)[g])
    # decode one token from the reference's own cache, grown to S
    grown = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, 1)]
                          + [(0, 0)] * (x.ndim - 3)), cj)
    dj, nj = jj.decode_step(params, jcfg, jnp.asarray(tok[:, n]), grown,
                            jnp.asarray(n, jnp.int32))
    mine = cache_from_jax(_np(grown), "cpu")
    dt, nt = tt.decode_step(model, tcfg, torch.from_numpy(tok[:, n]), mine, n)
    assert nt is mine
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    for g in nj:
        close(cache_to_jax(nt)[g], _np(nj)[g])


def test_prefill_decode_consistency_on_the_port(arch):
    """The reference's own check (``test_models_smoke``) on the port, with
    the prefill written into a preallocated cache of S rows; a MoE at the
    reference's drop-free capacity factor E / k * 1.05 (C >= T), so the two
    batches keep the same tokens."""
    tcfg, model, tok = arch["tcfg"], arch["model"], arch["tokens"]
    if tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe,
            capacity_factor=tcfg.moe.n_experts / tcfg.moe.top_k * 1.05))
    n = S - 1
    cache = tt.init_cache(tcfg, B, S, "cpu")
    _, cache = tt.prefill(model, tcfg, torch.from_numpy(tok[:, :n]),
                          cache=cache)
    for c in cache.values():
        for t in c.values():
            assert t[:, :, :n].any() and not t[:, :, n:].any()
    dec, _ = tt.decode_step(model, tcfg, torch.from_numpy(tok[:, n]), cache,
                            n)
    full, _ = tt.prefill(model, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_bf16_int8_variant(arch):
    jcfg = dataclasses.replace(arch["jcfg"], dtype="bfloat16",
                               kv_cache_dtype="int8")
    tcfg = dataclasses.replace(arch["tcfg"], dtype="bfloat16",
                               kv_cache_dtype="int8")
    params, model = _pair(jcfg, tcfg, seed=2)
    assert model.lm_head.weight.dtype == torch.bfloat16
    if tcfg.moe is not None:        # the router stays float32
        assert model.groups()[-1][0].moe.router.weight.dtype == torch.float32
    tok = arch["tokens"]
    n = S - 1
    lj, cj = jj.prefill(params, jcfg, jnp.asarray(tok[:, :n]))
    grown = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, 1)]
                          + [(0, 0)] * (x.ndim - 3)), cj)
    dj, _ = jj.decode_step(params, jcfg, jnp.asarray(tok[:, n]), grown,
                           jnp.asarray(n, jnp.int32))
    cache = tt.init_cache(tcfg, B, S, "cpu")
    lt, cache = tt.prefill(model, tcfg, torch.from_numpy(tok[:, :n]),
                           cache=cache)
    dt, _ = tt.decode_step(model, tcfg, torch.from_numpy(tok[:, n]), cache, n)
    for got, want in ((lt, lj), (dt, dj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0.1,
                                   atol=0.15)


def test_lma_token_table():
    """tinyllama's smoke config with an LMA token table (the paper's pool
    over the vocabulary): the lookup bit-identical, prefill and decode
    within 1e-5."""
    base_j = j_get("tinyllama-1.1b").make_smoke()
    base_t = t_get("tinyllama-1.1b").make_smoke()
    V, d = base_j.vocab_size, base_j.d_model
    jcfg = dataclasses.replace(base_j, embedding=j_emb(
        "lma", (V,), d, expansion=16.0, max_set=32))
    tcfg = dataclasses.replace(base_t, embedding=t_emb(
        "lma", (V,), d, expansion=16.0, max_set=32))
    store = synthetic_dense_store(V, 16, max_set=32, seed=0)
    jb = JTable(jcfg.embedding).make_buffers(store)
    tb = buffers_from_numpy(_np(jb), "cpu")
    params, model = _pair(jcfg, tcfg, seed=3)
    assert tuple(model.embed["memory"].shape) == \
        params["embed"]["memory"].shape == (tcfg.embedding.budget,)
    tok = np.random.default_rng(5).integers(0, V, (B, S)).astype(np.int32)
    ej = jj.embed_tokens(params, jcfg, jnp.asarray(tok), jb)
    et = tt.embed_tokens(model, tcfg, torch.from_numpy(tok), tb)
    np.testing.assert_array_equal(et.detach().numpy(), np.asarray(ej))
    n = S - 1
    lj, cj = jj.prefill(params, jcfg, jnp.asarray(tok[:, :n]), jb)
    cache = tt.init_cache(tcfg, B, S, "cpu")
    lt, cache = tt.prefill(model, tcfg, torch.from_numpy(tok[:, :n]), tb,
                           cache=cache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    grown = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, 1)]
                          + [(0, 0)] * (x.ndim - 3)), cj)
    dj, _ = jj.decode_step(params, jcfg, jnp.asarray(tok[:, n]), grown,
                           jnp.asarray(n, jnp.int32), jb)
    dt, _ = tt.decode_step(model, tcfg, torch.from_numpy(tok[:, n]), cache,
                           n, tb)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
