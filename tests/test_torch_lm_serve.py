"""The port's LM serving (``repro_torch.serve.lm``, ``repro_torch.data.
lm_data``, ``examples/lm_generate_torch.py``) against the reference's
``repro.serve.LMServer`` and ``repro.data.lm_data`` on the CPU.

Greedy tokens follow the argmax of logits that agree within 1e-5, so they
are held equal wherever the reference's top-2 margin exceeds 1e-4; a
sequence is compared up to its first step with a smaller margin (the two
histories part there), and every such step is reported.  Each step's
teacher-forced logits (both packages fed the reference's tokens) are held
within 1e-5.
"""
from __future__ import annotations

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


def _ref_wave_logits(server, params, wave, tokens_out, pad_to):
    """The reference's logits at each step of a wave, fed ``tokens_out``
    (teacher forcing; a finished sequence is fed its last token): [steps,
    n, V], through ``server``'s own jitted prefill and decode."""
    n, plen = len(wave), max(len(p) for p in wave)
    toks = np.zeros((n, plen), np.int32)
    for i, p in enumerate(wave):
        toks[i, plen - len(p):] = p
    logits, cache = server._prefill(params, jnp.asarray(toks))
    cache = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, 0)] * 2 + [(0, pad_to - x.shape[2])]
                          + [(0, 0)] * (x.ndim - 3)), cache)
    out = [np.asarray(logits)]
    for step in range(1, max(len(t) for t in tokens_out)):
        cur = np.asarray([t[min(step, len(t)) - 1] for t in tokens_out],
                         np.int32)
        logits, cache = server._decode(params, jnp.asarray(cur), cache,
                                       jnp.asarray(plen + step - 1,
                                                   jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out)


def _port_wave_logits(model, cfg, wave, tokens_out, pad_to):
    n, plen = len(wave), max(len(p) for p in wave)
    toks = np.zeros((n, plen), np.int32)
    for i, p in enumerate(wave):
        toks[i, plen - len(p):] = p
    cache = tt.init_cache(cfg, n, pad_to, "cpu")
    logits, cache = tt.prefill(model, cfg, torch.from_numpy(toks),
                               cache=cache)
    out = [logits.numpy()]
    for step in range(1, max(len(t) for t in tokens_out)):
        cur = torch.tensor([t[min(step, len(t)) - 1] for t in tokens_out],
                           dtype=torch.int32)
        logits, cache = tt.decode_step(model, cfg, cur, cache,
                                       plen + step - 1)
        out.append(logits.numpy())
    return np.stack(out)


def _margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("max_len,eos", [(64, None), (64, "eos"), (12, None)])
def test_lm_server_matches_reference(lm, max_len, eos):
    jcfg, tcfg, params, model, prompts = lm
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
        lj = _ref_wave_logits(ref, params, wave, forced, pad_to)
        lt = _port_wave_logits(model, tcfg, wave, forced, pad_to)
        np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
        margins = _margins(lj)
        for i, (w, g) in enumerate(zip(w_res, g_res)):
            assert g.prompt == w.prompt
            for step, tok in enumerate(w.tokens):
                if margins[step, i] <= MARGIN:
                    reported.append((lo + i, step, float(margins[step, i])))
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
        print(f"sequence {seq} step {step}: the reference's top-2 margin "
              f"{margin:.3g} <= {MARGIN}; compared up to there")


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
