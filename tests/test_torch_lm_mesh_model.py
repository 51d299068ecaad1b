"""The whole LM served under a (data, model) mesh on 4 gloo ranks (CPU):
the port's ``prefill``, ``decode_step`` and ``LMServer`` for the
tinyllama, deepseek-v3 and llama4-scout smoke configs (float32, float
and int8 caches, the MoE at the drop-free capacity factor) under (1, 4)
and (2, 2): a prefill into a 16-row cache and 3 decode steps.

The oracle is the reference's ONE-device ``prefill`` / ``decode_step``:
its meshed ``decode_step`` raises under JAX 0.9 (``ShardingTypeError``,
"dynamic_update_slice operand sharding must be equal to update
sharding"), and at a drop-free capacity the meshed and one-device paths
compute the same values.  Logits within 1e-5 (the tolerance
``tests/test_torch_lm_serve.py`` holds the one-card port to); with an
int8 cache, a batch row within 1e-5 until its cache first parts from the
one-card port's by an int8 rounding step and within the int8 bound (rtol
0.1, atol 0.15) after.  Caches against the one-card port's slabs:
bit-equal where the mesh changes no input (every prefill row up to the
first MoE layer's output, layer 0's decode writes); every other written
row within 1e-5 of the largest value (float) or equal up to one int8 step
(the merge sums a layer's attention in another order, which moves the
next layer's K/V in the last bits); rows never written stay zero.  Every
rank returns the same logits.  The ``LMServer``'s tokens equal the
one-card port's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lm_mesh_ranks as lr  # noqa: E402
from test_torch_lm_transformer import _jinit, _np, jj  # noqa: E402
from repro.configs.base import get_config as j_get  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_RTOL, INT8_ATOL = 0.1, 0.15
LM_MESHES = ((1, 4), (2, 2))


# ------------------------------------------------------------ the whole LM

def _reference_run(jcfg, params, toks) -> list:
    """The reference's one-device prefill and decode steps -> logits."""
    logits, cache = jj.prefill(params, jcfg, jnp.asarray(toks["prompt"]))
    out = [np.asarray(logits)]
    cache = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, lr.LM_L - lr.LM_S)]
                          + [(0, 0)] * (x.ndim - 3)), cache)
    for t in range(lr.LM_STEPS):
        logits, cache = jj.decode_step(
            params, jcfg, jnp.asarray(toks["steps"][t]), cache,
            jnp.asarray(lr.LM_S + t, jnp.int32))
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def lm_runs():
    runs, refs, ones = [], {}, {}
    for ai, arch in enumerate(lr.LM_ARCHS):
        for quant in (False, True):
            jcfg = j_get(arch).make_smoke()
            if jcfg.moe is not None:
                jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                    jcfg.moe, capacity_factor=jcfg.moe.n_experts
                    / jcfg.moe.top_k * 1.05))
            if quant:
                jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
            params = _jinit(jcfg, 10 + ai)
            toks = lr.lm_tokens(jcfg.vocab_size, 20 + ai)
            np_params = _np(params)
            runs.append((arch, quant, np_params, toks))
            refs[arch, quant] = _reference_run(jcfg, params, toks)
            ones[arch, quant] = lr.lm_run(lr.lm_config(arch, quant),
                                          np_params, toks)
    ranks = {m: run_ranks(lr.lm_rank, m[0] * m[1], runs, data=m[0],
                          device="cpu") for m in LM_MESHES}
    return runs, refs, ones, ranks


def _first_moe_layer(cfg) -> int:
    """The index of the first layer whose FFN is a MoE (its output is the
    first that the mesh computes in another order), or n_layers."""
    return cfg.first_k_dense if cfg.moe is not None else cfg.n_layers


def _cache_rows_held(one: dict, got: dict, slab, cfg, step: int,
                     what: str) -> np.ndarray:
    """``got`` (a rank's slab) against the one-card cache's same rows ->
    [B_l] bool: the rows whose int8 cache parted (by one step)."""
    (b0, b1), (lo, hi) = slab
    parted = np.zeros(b1 - b0, bool)
    first_moe = _first_moe_layer(cfg)
    layer0 = 0
    for gi, (_kind, count) in enumerate(cfg.layer_groups()):
        for name, want_all in one[f"layers_{gi}"].items():
            want = want_all[:, b0:b1, lo:hi]
            g = got[f"layers_{gi}"][name]
            assert g.shape == want.shape, what
            written = lr.LM_S + step          # rows [0, written) hold data
            w_hi = max(0, min(hi, written) - lo)
            np.testing.assert_array_equal(g[:, :, w_hi:], 0, err_msg=what)
            for li in range(count):
                layer = layer0 + li
                exact_pre = layer <= first_moe     # prefill rows
                a, b = g[li, :, :w_hi], want[li, :, :w_hi]
                p_hi = max(0, min(hi, lr.LM_S) - lo)
                if exact_pre:
                    np.testing.assert_array_equal(a[:, :p_hi], b[:, :p_hi],
                                                  err_msg=f"{what} {name}")
                if layer == 0:
                    np.testing.assert_array_equal(a, b, err_msg=what)
                    continue
                if g.dtype == np.int8:
                    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                    assert d.max(initial=0) <= 1, (what, name, layer)
                    parted |= d.reshape(d.shape[0], -1).max(
                        -1, initial=0) > 0
                else:
                    scale = max(float(np.abs(b).max(initial=0)), 1.0)
                    np.testing.assert_allclose(a, b, rtol=0,
                                               atol=1e-5 * scale,
                                               err_msg=f"{what} {name}")
        layer0 += count
    return parted


@pytest.mark.parametrize("mesh", LM_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_meshed_decode_matches_one_device_reference(lm_runs, mesh):
    runs, refs, ones, ranks = lm_runs
    for ri, (arch, quant, _p, _t) in enumerate(runs):
        cfg = lr.lm_config(arch, quant)
        want = refs[arch, quant]
        one = ones[arch, quant]
        rank0 = ranks[mesh][0][ri]
        for r in ranks[mesh]:
            for a, b in zip(r[ri]["logits"], rank0["logits"]):
                np.testing.assert_array_equal(a, b)      # the same everywhere
        parted = np.zeros(lr.LM_B, bool)
        for step in range(lr.LM_STEPS + 1):
            what = f"{arch} int8={quant} {mesh} step {step}"
            for r in ranks[mesh]:
                (b0, b1), _ = r[ri]["slab"]
                parted[b0:b1] |= _cache_rows_held(
                    one["caches"][step], r[ri]["caches"][step],
                    r[ri]["slab"], cfg, step, what)
            got, ref = rank0["logits"][step], want[step]
            for b in range(lr.LM_B):
                if parted[b]:
                    np.testing.assert_allclose(got[b], ref[b],
                                               rtol=INT8_RTOL,
                                               atol=INT8_ATOL, err_msg=what)
                else:
                    np.testing.assert_allclose(got[b], ref[b], **TOL,
                                               err_msg=what)


@pytest.mark.parametrize("mesh", LM_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_meshed_server_matches_one_card(lm_runs, mesh):
    runs, _refs, ones, ranks = lm_runs
    for ri, (arch, quant, _p, _t) in enumerate(runs):
        for r in ranks[mesh]:
            assert r[ri]["served"] == ones[arch, quant]["served"], \
                (arch, quant, mesh)


def test_cache_slabs_tile_the_cache(lm_runs):
    """(1, 4) spreads B = 4's length over all four ranks; (2, 2) puts the
    batch over 'data' and the length over 'model'."""
    _runs, _refs, _ones, ranks = lm_runs
    assert [r[0]["slab"] for r in ranks[1, 4]] == [
        ((0, 4), (4 * i, 4 * i + 4)) for i in range(4)]
    assert [r[0]["slab"] for r in ranks[2, 2]] == [
        ((0, 2), (0, 8)), ((0, 2), (8, 16)), ((2, 4), (0, 8)),
        ((2, 4), (8, 16))]
