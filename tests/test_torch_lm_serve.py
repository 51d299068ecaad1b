"""The port's LM serving (``repro_torch.serve.lm``, ``repro_torch.data.
lm_data``, ``examples/lm_generate_torch.py``) against the reference's
``repro.serve.LMServer`` and ``repro.data.lm_data`` on the CPU.

Greedy tokens follow the argmax of logits that agree within 1e-5, so they
are held equal wherever the reference's top-2 margin exceeds 1e-4; a
sequence is compared up to its first step with a smaller margin (the two
histories part there), and every such step is reported.  Each step's
teacher-forced logits (both packages fed the reference's tokens) are held
within 1e-5.  With an int8 cache, a latent within float32 noise of a
rounding tie may round to the neighbouring int8 step: a sequence's cache
is held equal to the reference's up to the step where it first parts, one
step apart there, and its logits within 1e-5 before that step and within
the int8 bound (rtol 0.1, atol 0.15, tests/test_kv_quant.py) from it on.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as j_get  # noqa: E402
from repro.data.lm_data import LMGenerator as JGen  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import LMServer as JServer  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data.lm_data import LMGenerator as TGen  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serve import GenerationResult, LMServer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MARGIN = 1e-4
INT8_RTOL, INT8_ATOL = 0.1, 0.15
N_SLOTS, MAX_NEW = 3, 8


@pytest.mark.parametrize("vocab,seed", [(512, 0), (32000, 3)])
def test_lm_generator_bits_equal(vocab, seed):
    a, b = JGen(vocab, seed=seed), TGen(vocab, seed=seed)
    for name in ("successor", "is_patterned", "unigram", "perm"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for idx in (0, 7):
        x, y = a.batch(4, 33, idx), b.batch(4, 33, idx)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.fixture(scope="module")
def lm():
    jcfg = j_get("tinyllama-1.1b").make_smoke()
    tcfg = t_get("tinyllama-1.1b").make_smoke()
    params = jt.init(jax.random.key(0), jcfg)
    model = tt.init(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu"))
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size, n)))
               for n in (3, 9, 5, 6, 2)]                 # ragged, 2 waves
    return jcfg, tcfg, params, model, prompts


def _ref_wave_logits(server, params, wave, tokens_out, pad_to, caches=None):
    """The reference's logits at each step of a wave, fed ``tokens_out``
    (teacher forcing; a finished sequence is fed its last token): [steps,
    n, V], through ``server``'s own jitted prefill and decode; each step's
    cache appended to ``caches`` (numpy), where given."""
    n, plen = len(wave), max(len(p) for p in wave)
    toks = np.zeros((n, plen), np.int32)
    for i, p in enumerate(wave):
        toks[i, plen - len(p):] = p
    logits, cache = server._prefill(params, jnp.asarray(toks))
    cache = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, 0)] * 2 + [(0, pad_to - x.shape[2])]
                          + [(0, 0)] * (x.ndim - 3)), cache)
    out = [np.asarray(logits)]
    snap = (lambda: caches.append(jax.tree_util.tree_map(np.asarray, cache))
            ) if caches is not None else (lambda: None)
    snap()
    for step in range(1, max(len(t) for t in tokens_out)):
        cur = np.asarray([t[min(step, len(t)) - 1] for t in tokens_out],
                         np.int32)
        logits, cache = server._decode(params, jnp.asarray(cur), cache,
                                       jnp.asarray(plen + step - 1,
                                                   jnp.int32))
        out.append(np.asarray(logits))
        snap()
    return np.stack(out)


def _port_wave_logits(model, cfg, wave, tokens_out, pad_to, caches=None):
    n, plen = len(wave), max(len(p) for p in wave)
    toks = np.zeros((n, plen), np.int32)
    for i, p in enumerate(wave):
        toks[i, plen - len(p):] = p
    cache = tt.init_cache(cfg, n, pad_to, "cpu")
    logits, cache = tt.prefill(model, cfg, torch.from_numpy(toks),
                               cache=cache)
    out = [logits.numpy()]
    snap = (lambda: caches.append({g: {k: t.numpy().copy()
                                       for k, t in c.items()}
                                   for g, c in cache.items()})
            ) if caches is not None else (lambda: None)
    snap()
    for step in range(1, max(len(t) for t in tokens_out)):
        cur = torch.tensor([t[min(step, len(t)) - 1] for t in tokens_out],
                           dtype=torch.int32)
        logits, cache = tt.decode_step(model, cfg, cur, cache,
                                       plen + step - 1)
        out.append(logits.numpy())
        snap()
    return np.stack(out)


def _margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _int8_parting(jcs: list, tcs: list, n: int) -> list:
    """Per sequence of a wave, the first step at which its int8 cache
    differs from the reference's (the number of steps if none), held one
    int8 step apart there and its scales within 1e-5 before it."""
    parted = [len(jcs)] * n
    for step, (jc, tc) in enumerate(zip(jcs, tcs)):
        for g, leaves in jc.items():
            for name, w in leaves.items():
                got = tc[g][name]
                for i in range(n):
                    if step >= parted[i]:
                        continue
                    a, b = got[:, i], w[:, i]
                    if name.endswith("_scale"):
                        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
                        continue
                    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                    if d.max() > 0:
                        assert d.max() == 1, (i, step, g, name)
                        parted[i] = step
    return parted


def _hold_server(jcfg, tcfg, params, model, prompts, max_len, eos):
    """The port's LMServer against the reference's on ``prompts``: each
    wave's teacher-forced logits within 1e-5, the greedy tokens equal up
    to a sequence's first step whose top-2 margin is <= 1e-4 (reported);
    with an int8 cache, up to its first step whose cache rounds to a
    neighbouring int8 step (reported), and within the int8 bound after."""
    if eos == "eos":
        # a token the reference generates mid-way in the first sequence
        first = JServer(params, jcfg, n_slots=N_SLOTS, max_len=max_len)
        eos = first.generate(prompts, max_new_tokens=MAX_NEW)[0].tokens[3]
    ref = JServer(params, jcfg, n_slots=N_SLOTS, max_len=max_len, eos_id=eos)
    if eos is not None:
        ref._prefill, ref._decode = first._prefill, first._decode
    port = LMServer(model, tcfg, n_slots=N_SLOTS, max_len=max_len, eos_id=eos)
    want = ref.generate(prompts, max_new_tokens=MAX_NEW)
    got = port.generate(prompts, max_new_tokens=MAX_NEW)
    assert all(isinstance(r, GenerationResult) for r in got)
    reported = []
    for lo in range(0, len(prompts), N_SLOTS):
        wave = prompts[lo: lo + N_SLOTS]
        w_res, g_res = want[lo: lo + N_SLOTS], got[lo: lo + N_SLOTS]
        plen = max(len(p) for p in wave)
        pad_to = min(max_len, plen + MAX_NEW)
        forced = [r.tokens for r in w_res]
        jcs, tcs = ([], []) if tcfg.kv_quantized else (None, None)
        lj = _ref_wave_logits(ref, params, wave, forced, pad_to, jcs)
        lt = _port_wave_logits(model, tcfg, wave, forced, pad_to, tcs)
        parted = (_int8_parting(jcs, tcs, len(wave)) if tcfg.kv_quantized
                  else [len(lj)] * len(wave))
        for i, k in enumerate(parted):
            np.testing.assert_allclose(lt[:k, i], lj[:k, i], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(lt[k:, i], lj[k:, i], rtol=INT8_RTOL,
                                       atol=INT8_ATOL)
        margins = _margins(lj)
        for i, (w, g) in enumerate(zip(w_res, g_res)):
            assert g.prompt == w.prompt
            for step, tok in enumerate(w.tokens):
                if margins[step, i] <= MARGIN:
                    reported.append((lo + i, step, float(margins[step, i])))
                    break
                if step >= parted[i]:
                    reported.append((lo + i, step, "int8 rounding"))
                    break
                assert step < len(g.tokens) and g.tokens[step] == tok, \
                    (lo + i, step)
            else:
                assert g.tokens == w.tokens and g.finished == w.finished
    if not reported:
        assert port.stats == ref.stats
    if eos is not None:
        assert any(r.finished for r in want)
    for seq, step, margin in reported:
        why = (margin if isinstance(margin, str) else
               f"the reference's top-2 margin {margin:.3g} <= {MARGIN}")
        print(f"sequence {seq} step {step}: {why}; compared up to there")


@pytest.mark.parametrize("max_len,eos", [(64, None), (64, "eos"), (12, None)])
def test_lm_server_matches_reference(lm, max_len, eos):
    jcfg, tcfg, params, model, prompts = lm
    _hold_server(jcfg, tcfg, params, model, prompts, max_len, eos)


MOE_ARCHS = ["deepseek-v3-671b", "llama4-scout-17b-a16e"]


@functools.lru_cache(maxsize=None)
def _moe_lm(arch):
    """-> (reference config, port config, reference parameters, port model
    loaded with them) of ``arch``'s smoke config."""
    jcfg = j_get(arch).make_smoke()
    tcfg = t_get(arch).make_smoke()
    params = jt.init(jax.random.key(1), jcfg)
    model = tt.init(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu"))
    return jcfg, tcfg, params, model


def _count_drops(monkeypatch) -> list:
    """Each ``moe_apply`` call's dropped assignments, from its stats."""
    from repro_torch.nn import moe as tmoe
    dropped = []
    apply = tmoe.moe_apply

    def counted(p, cfg, x):
        stats = {}
        out = apply(p, cfg, x, stats=stats)
        dropped.append(int(tmoe.dropped(stats["load"], stats["C"])))
        return out

    monkeypatch.setattr(tmoe, "moe_apply", counted)
    return dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("lengths,drop_free", [
    ((30, 30, 30, 12, 12), False), ((30, 7, 19, 12, 3), True)])
def test_moe_lm_server_matches_reference(arch, lengths, drop_free,
                                         monkeypatch):
    """The MoE and MLA smoke configs, float32 and an int8 cache.  At their
    own capacity factor (1.25) the waves' prefills drop tokens (counted on
    the port), as the reference's do; each wave's prompts then have one
    length, since a left pad repeats token 0, whose copies are equal in
    exact arithmetic but get routing weights a last bit apart on either
    side, and an over-capacity expert's choice among such ties follows
    those bits, not the port.  At the reference's drop-free factor E / k *
    1.05 (tests/test_models_smoke.py) no tie order picks a token, so waves
    of mixed lengths hold the left padding and the MoE together."""
    jcfg, tcfg, params, model = _moe_lm(arch)
    if drop_free:
        factor = jcfg.moe.n_experts / jcfg.moe.top_k * 1.05
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=factor)) for c in (jcfg, tcfg))
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab_size, n)))
               for n in lengths]
    dropped = _count_drops(monkeypatch)
    for kv in (None, "int8"):
        jc = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        tc = dataclasses.replace(tcfg, kv_cache_dtype=kv)
        _hold_server(jc, tc, params, model, prompts, 64, None)
    assert dropped and (sum(dropped) == 0) == drop_free


def test_lm_server_equals_its_hand_rolled_decode(lm):
    _jcfg, tcfg, _params, model, prompts = lm
    wave = prompts[:N_SLOTS]
    server = LMServer(model, tcfg, n_slots=N_SLOTS, max_len=64)
    got = server.generate(wave, max_new_tokens=MAX_NEW)
    plen = max(len(p) for p in wave)
    toks = np.zeros((len(wave), plen), np.int32)
    for i, p in enumerate(wave):
        toks[i, plen - len(p):] = p
    cache = tt.init_cache(tcfg, len(wave), plen + MAX_NEW, "cpu")
    logits, cache = tt.prefill(model, tcfg, torch.from_numpy(toks),
                               cache=cache)
    out = [torch.argmax(logits, -1)]
    for step in range(1, MAX_NEW):
        logits, cache = tt.decode_step(model, tcfg, out[-1].to(torch.int32),
                                       cache, plen + step - 1)
        out.append(torch.argmax(logits, -1))
    hand = torch.stack(out, dim=1).tolist()
    assert [r.tokens for r in got] == hand
    assert server.stats == {"waves": 1, "decode_steps": MAX_NEW - 1,
                            "generated": len(wave) * MAX_NEW}


def test_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "lm_generate_torch", ROOT / "examples" / "lm_generate_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--steps", "3"])
    assert np.isfinite(out["loss"])
    assert len(out["results"]) == 6 and out["stats"]["waves"] == 2
    assert all(len(r.tokens) == 16 for r in out["results"])
    assert "bigram-successor hit rate" in capsys.readouterr().out
