"""Training the port's LMs (``repro_torch.models.transformer``) against the
JAX reference on the CPU, at the smoke configs of tinyllama-1.1b (GQA),
deepseek-v3-671b (MLA, a dense layer then MoE layers), llama4-scout-17b-a16e
(GQA, MoE layers) and tinyllama's with an LMA token table (the paper's pool
over the vocabulary), each with ``remat`` on and a loss chunk below S:

(a) ``loss_fn``'s gradients, the port's autograd against ``jax.grad`` of
    the reference: every parameter within 1e-5 normwise (float32 matmuls
    and sums in another order), the losses within 1e-6 relative;
(b) remat on and off: losses and gradients bit-equal (int32 bit patterns);
    with remat each layer's ``_block`` runs twice a step (the forward, then
    its recompute in the backward), without it once, and no saved tensor
    is a chunk's [B, chunk, V] logits either way;
(c) the LMA-LM through both packages' Trainers and launchers' optimizers
    (Adam, the pool on lazy row-wise Adam), 3 steps sparse and 3 dense,
    remat on: each loss within 1e-5 of the reference Trainer's, the pool
    after 3 steps within 1e-6 normwise;
(d) with remat on, ``prefill`` and ``decode_step`` give the bits they give
    with it off, each layer run once.
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
from repro.data.lm_data import LMGenerator as JLMGenerator  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs._recsys_common import \
    embedding_of_kind as t_emb  # noqa: E402
from repro_torch.convert import buffers_from_numpy, lm_params_from_jax  # noqa: E402
from repro_torch.data.lm_data import LMGenerator  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

LMA = "tinyllama-1.1b+lma"
ARCHS = ["tinyllama-1.1b", "deepseek-v3-671b", "llama4-scout-17b-a16e", LMA]
B, S, CHUNK = 2, 16, 8
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 32, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jinit(jcfg, seed: int) -> dict:
    """Parameters in the reference's tree, drawn by numpy as its init
    scales them (``tests/test_torch_lm_transformer.py``'s ``_jinit``)."""
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


def _configs(name: str, **kw):
    """-> (reference config, port config, reference buffers, port
    buffers), remat on and the loss chunked unless ``kw`` says otherwise."""
    arch = name.split("+")[0]
    jcfg, tcfg = j_get(arch).make_smoke(), t_get(arch).make_smoke()
    jb = tb = None
    if name == LMA:
        V, d = jcfg.vocab_size, jcfg.d_model
        jcfg = dataclasses.replace(jcfg, embedding=j_emb(
            "lma", (V,), d, expansion=16.0, max_set=32))
        tcfg = dataclasses.replace(tcfg, embedding=t_emb(
            "lma", (V,), d, expansion=16.0, max_set=32))
        store = synthetic_dense_store(V, 16, max_set=32, seed=0)
        jb = JTable(jcfg.embedding).make_buffers(store)
        tb = buffers_from_numpy(_np(jb), "cpu")
    kw = {"remat": True, "loss_chunk": CHUNK, **kw}
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw),
            jb, tb)


def _model(tcfg, params) -> tt.Transformer:
    model = tt.init(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(_np(params), tcfg, "cpu"))
    return model


def _port_grads(model, tcfg, tok, lab, tb):
    model.zero_grad(set_to_none=True)
    loss, _ = tt.loss_fn(model, tcfg, torch.from_numpy(tok),
                         torch.from_numpy(lab), tb)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


def _tokens(V: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, (B, S)).astype(np.int32))


def _jax_grad(jcfg):
    def lf(p, tok, lab, bufs):
        return jt.loss_fn(p, jcfg, tok, lab, bufs)[0]
    return jax.jit(jax.value_and_grad(lf))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_gradients_match_reference(name):
    jcfg, tcfg, jb, tb = _configs(name)
    params = _jinit(jcfg, seed=0)
    tok, lab = _tokens(jcfg.vocab_size, seed=1)
    jloss, jgrads = _jax_grad(jcfg)(params, jnp.asarray(tok),
                                    jnp.asarray(lab), jb)
    loss, grads = _port_grads(_model(tcfg, params), tcfg, tok, lab, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = lm_params_from_jax(_np(jgrads), tcfg, "cpu")
    assert want.keys() == grads.keys()
    for k, g in grads.items():
        ref = want[k].to(torch.float32)
        diff = float(torch.linalg.vector_norm(g.to(torch.float32) - ref))
        assert diff <= 1e-5 * float(torch.linalg.vector_norm(ref)), \
            (k, diff, float(torch.linalg.vector_norm(ref)))
    if name == LMA:
        assert float(torch.linalg.vector_norm(grads["embed.memory"])) > 0


class _Counted:
    """Within: ``transformer._block`` counts its calls."""

    def __enter__(self):
        self.saved, self.calls = tt._block, 0

        def block(*a, **kw):
            self.calls += 1
            return self.saved(*a, **kw)
        tt._block = block
        return self

    def __exit__(self, *exc):
        tt._block = self.saved


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy().view(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_on_and_off_bit_equal(name):
    jcfg, tcfg, _, tb = _configs(name)
    params = _jinit(jcfg, seed=4)
    tok, lab = _tokens(tcfg.vocab_size, seed=5)
    V = tcfg.vocab_size
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = _model(cfg, params)
        shapes = []

        def pack(x):
            shapes.append(tuple(x.shape))
            return x
        with _Counted() as c, \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            loss, grads = _port_grads(model, cfg, tok, lab, tb)
        assert c.calls == cfg.n_layers * (2 if remat else 1), c.calls
        assert (B, CHUNK, V) not in shapes
        out[remat] = (loss, grads)
    (l1, g1), (l0, g0) = out[True], out[False]
    np.testing.assert_array_equal(_bits(l1), _bits(l0))
    assert g1.keys() == g0.keys()
    for k in g1:
        np.testing.assert_array_equal(_bits(g1[k]), _bits(g0[k]),
                                      err_msg=k)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_lma_lm_trainers_agree(sparse):
    arch_j, arch_t = j_get("tinyllama-1.1b"), t_get("tinyllama-1.1b")
    jcfg, tcfg, jb, tb = _configs(LMA, loss_chunk=TRAIN_S // 2)
    params = _jinit(jcfg, seed=6)
    model = _model(tcfg, params)
    start = torch.from_numpy(np.array(params["embed"]["memory"]))
    jgen, tgen = JLMGenerator(jcfg.vocab_size, seed=0), \
        LMGenerator(tcfg.vocab_size, seed=0)

    def jbatch(step):
        return {k: jnp.asarray(v) for k, v in
                jgen.batch(TRAIN_B, TRAIN_S, step).items()}

    def jloss(p, b):
        return jt.loss_fn(p, jcfg, b["tokens"], b["labels"], jb)

    def tloss(m, b):
        return tt.loss_fn(m, tcfg, b["tokens"], b["labels"], tb)

    jtr = JTrainer(JTrainerConfig(total_steps=0, log_every=0), jloss, params,
                   jlaunch.make_optimizer(arch_j), jbatch,
                   sparse_grads=sparse)
    ttr = Trainer(TrainerConfig(total_steps=0, log_every=0), tloss, model,
                  tlaunch.make_optimizer(arch_t),
                  lambda step: tgen.batch(TRAIN_B, TRAIN_S, step),
                  sparse_grads=sparse, device="cpu")
    assert jtr.sparse_grads == ttr.sparse_grads == sparse
    for s in range(1, TRAIN_STEPS + 1):
        jtr.cfg.total_steps = ttr.cfg.total_steps = s
        jl = jtr.fit(log=lambda _: None)["loss"]
        tl = ttr.fit(log=lambda _: None)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5,
                                   err_msg=f"step {s}")
    pool = ttr.params["embed.memory"].detach()
    if sparse:
        assert ttr.params["embed.memory"].grad is None
    want = torch.from_numpy(np.array(jtr.params["embed"]["memory"]))
    assert not torch.equal(pool, start)
    assert float(torch.linalg.vector_norm(pool - want)) <= \
        1e-6 * float(torch.linalg.vector_norm(want))


@pytest.mark.parametrize("name", ARCHS)
def test_serving_unchanged_by_remat(name):
    jcfg, tcfg, _, tb = _configs(name)
    params = _jinit(jcfg, seed=7)
    tok, _ = _tokens(tcfg.vocab_size, seed=8)
    n = S - 1
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = _model(cfg, params)
        cache = tt.init_cache(cfg, B, S, "cpu")
        with _Counted() as c:
            logits, cache = tt.prefill(model, cfg, torch.from_numpy(
                tok[:, :n]), tb, cache=cache)
            dec, cache = tt.decode_step(model, cfg, torch.from_numpy(
                tok[:, n]), cache, n, tb)
        assert c.calls == cfg.n_layers
        out[remat] = (logits, dec, cache)
    for a, b in zip(out[True][:2], out[False][:2]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for g, c in out[True][2].items():
        for k, t in c.items():
            assert torch.equal(t, out[False][2][g][k]), (g, k)
