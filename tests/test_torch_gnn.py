"""The GAT in the port against the JAX reference in the same process, at
smoke size.

Data: ``sbm_graph``, ``NeighborSampler`` (its CSR and a run of blocks,
a node of degree 0 among the seeds), ``pad_block`` and ``molecule_batch``
bit-identical.  Config: every shape's ``make_model`` and ``make_smoke``
field-equal, the registry entry equal.  One layer (``gat_conv``, chunk
lengths 1, 7 and E, and ``gat_conv_plain``), concatenated heads and the head
mean, on a graph with self loops and on one without (empty segments) with a
masked padded tail onto an all-masked node: outputs within 1e-6 of the
reference's max |value|, the gradient of every leaf (x, w, a_src, a_dst)
within 1e-5 of its max |g| under a random cotangent.  The whole model on a
node-level graph, a molecule batch (mean readout), a padded sampled block
and with node ids through an LMA and a full table (dense gradients):
logits, loss and accuracy, gradients to the same tolerances.  Five Adam
steps through both Trainers, each from the reference's state (the
``tests/test_torch_rm2_widths.py`` rule: losses within 1e-6 relative,
parameters within 1e-5 but where Adam acts as a sign function).  The
launcher's family dispatch: ``gnn`` refused as the reference refuses it,
``lm`` trained at smoke size."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs._recsys_common import \
    embedding_of_kind as jembedding  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.configs.gat_cora import GNN_SHAPES as JSHAPES  # noqa: E402
from repro.configs.gat_cora import make_model as jmake  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.data import graph as jgraph  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpoint.manager import _flatten, _host  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs._recsys_common import embedding_of_kind  # noqa: E402
from repro_torch.configs.gat_cora import GNN_SHAPES, make_model  # noqa: E402
from repro_torch.convert import (buffers_from_numpy,  # noqa: E402
                                 gnn_params_from_jax, state_from_jax)
from repro_torch.data import graph as tgraph  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       _load, _restored)

OUT_TOL, GRAD_TOL = 1e-6, 1e-5
LR = 5e-3
SIGN_SHARE = 0.05


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    """max |got - want| / max |want|."""
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / max(np.abs(want).max(),
                                                    1e-30))


def _graph_equal(a, b):
    for f in ("src", "dst", "features", "labels", "train_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.n_nodes == b.n_nodes


def _dict_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("args", [(200, 800, 16, 5, 0), (313, 1000, 7, 3, 4),
                                  (50, 60, 3, 9, 2)])
def test_sbm_graph_bit_identical(args):
    _graph_equal(tgraph.sbm_graph(*args), jgraph.sbm_graph(*args))


def _no_loop_graph(lib, n=40, e=90, seed=3):
    """A Graph without self loops whose nodes 0 and n - 1 have no in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(1, n - 1, e).astype(np.int32)
    return lib.Graph(src, dst, rng.normal(size=(n, 4)).astype(np.float32),
                     rng.integers(0, 3, n).astype(np.int32), n)


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("fanouts", [(4, 3), (2,)])
def test_neighbor_sampler_bit_identical(seed, fanouts):
    gj = jgraph.sbm_graph(300, 1500, 8, 3, seed=seed)
    gt = tgraph.sbm_graph(300, 1500, 8, 3, seed=seed)
    js = jgraph.NeighborSampler(gj, fanouts, seed=seed)
    ts = tgraph.NeighborSampler(gt, fanouts, seed=seed)
    np.testing.assert_array_equal(ts.indptr, js.indptr)
    assert ts.indptr.dtype == js.indptr.dtype
    np.testing.assert_array_equal(ts.in_src, js.in_src)
    rng = np.random.default_rng(seed + 10)
    for _ in range(3):                       # the rng runs on across blocks
        seeds = rng.choice(300, 17, replace=False)
        _dict_equal(ts.sample(seeds), js.sample(seeds))


def test_neighbor_sampler_degree_zero_bit_identical():
    js = jgraph.NeighborSampler(_no_loop_graph(jgraph), (3, 2), seed=7)
    ts = tgraph.NeighborSampler(_no_loop_graph(tgraph), (3, 2), seed=7)
    np.testing.assert_array_equal(ts.indptr, js.indptr)
    assert ts.indptr[1] == 0                 # node 0: degree 0
    for seeds in ([0], [0, 5, 39], [0, 39]):  # 0 and 39 have no in-edges
        _dict_equal(ts.sample(np.asarray(seeds)),
                    js.sample(np.asarray(seeds)))


def test_pad_block_bit_identical():
    gj, gt = (lib.sbm_graph(200, 900, 8, 3, seed=2) for lib in (jgraph,
                                                                tgraph))
    bj = jgraph.NeighborSampler(gj, (3, 2), seed=0).sample(np.arange(6))
    bt = tgraph.NeighborSampler(gt, (3, 2), seed=0).sample(np.arange(6))
    _dict_equal(tgraph.pad_block(bt, 64, 140), jgraph.pad_block(bj, 64, 140))
    with pytest.raises(ValueError, match="exceeds"):
        tgraph.pad_block(bt, bt["n_nodes"] - 1, 140)


@pytest.mark.parametrize("args", [(8, 10, 20, 8, 6, 0), (3, 30, 64, 32, 10,
                                                          5)])
def test_molecule_batch_bit_identical(args):
    _dict_equal(tgraph.molecule_batch(*args), jgraph.molecule_batch(*args))


# ----------------------------------------------------------------- config

def test_configs_equal_the_reference():
    assert GNN_SHAPES == JSHAPES
    for shape in (None, *GNN_SHAPES):
        assert dataclasses.asdict(make_model(shape)) == \
            dataclasses.asdict(jmake(shape)), shape
    a, b = tget("gat-cora"), jget("gat-cora")
    assert dataclasses.asdict(a.make_smoke()) == \
        dataclasses.asdict(b.make_smoke())
    for f in ("arch_id", "family", "shapes", "optimizer", "learning_rate",
              "source", "notes"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.family, a.optimizer, a.learning_rate) == ("gnn", "adam", 5e-3)


# -------------------------------------------------------------- one layer

def _layer_case(graph: str):
    """(x, src, dst, mask, n) of a graph with self loops, or of one without
    (nodes with no in-edge) whose padded tail of masked edges points at an
    all-masked node."""
    rng = np.random.default_rng(11)
    if graph == "loops":
        g = jgraph.sbm_graph(30, 70, 6, 3, seed=1)
        return g.features, g.src, g.dst, None, g.n_nodes
    n, e, pad = 25, 60, 9
    src = rng.integers(0, n - 2, e).astype(np.int32)
    dst = rng.integers(0, n - 4, e).astype(np.int32)    # n-4.. get none
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.full(pad, n - 1, np.int32)])
    mask = np.arange(e + pad) < e
    mask[::13] = False                                  # masked real edges
    x = rng.normal(size=(n, 6)).astype(np.float32)
    return x, src, dst, mask, n


def _layer_params(rng, f, h, d):
    return {"w": (rng.normal(size=(f, h, d)) / np.sqrt(f)).astype(np.float32),
            "a_src": rng.normal(size=(h, d)).astype(np.float32),
            "a_dst": rng.normal(size=(h, d)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _layer_reference(graph: str, concat: bool):
    """A layer case's inputs, parameters and cotangent, and the reference's
    output and gradients (x, w, a_src, a_dst) under that cotangent."""
    x, src, dst, mask, n = _layer_case(graph)
    rng = np.random.default_rng(5)
    p = _layer_params(rng, x.shape[1], 4, 5)
    cot = rng.normal(size=(n, 20 if concat else 5)).astype(np.float32)

    def ref(p, x):
        return jgnn.gat_conv(p, x, jnp.asarray(src), jnp.asarray(dst), n,
                             negative_slope=0.2, concat_heads=concat,
                             edge_mask=None if mask is None
                             else jnp.asarray(mask))

    def run(p, x):
        out, vjp = jax.vjp(ref, p, x)
        return out, vjp(jnp.asarray(cot))
    want, want_g = jax.tree_util.tree_map(np.asarray, jax.jit(run)(p, x))
    return (x, src, dst, mask, n), p, cot, want, want_g


@pytest.mark.parametrize("chunk", [1, 7, "E", "plain"])
@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("graph", ["loops", "no_loops_masked"])
def test_layer_matches_reference(graph, concat, chunk):
    (x, src, dst, mask, n), p, cot, want, want_g = _layer_reference(graph,
                                                                    concat)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    kw = dict(negative_slope=0.2, concat_heads=concat,
              edge_mask=None if mask is None else _t(mask))
    if chunk == "plain":
        got = tgnn.gat_conv_plain(tp, tx, _t(src), _t(dst), n, **kw)
    else:
        got = tgnn.gat_conv(tp, tx, _t(src), _t(dst), n, **kw,
                            chunk=len(src) if chunk == "E" else chunk)
    (got * _t(cot)).sum().backward()
    assert _rel(got.detach(), want) <= OUT_TOL
    assert bool(torch.isfinite(got).all())
    if mask is not None:                     # no live in-edge: output 0
        assert not got[n - 4:].detach().abs().any()
    for k in p:
        assert _rel(tp[k].grad, want_g[0][k]) <= GRAD_TOL, k
    assert _rel(tx.grad, want_g[1]) <= GRAD_TOL


def test_default_chunk_from_bytes():
    assert tgnn.edge_chunk(8, 47) == (1 << 30) // (8 * 47 * 4) == 713_924
    assert tgnn.edge_chunk(1 << 15, 1 << 15) == 1


# ----------------------------------------------------------- whole model

def _lma_buffers(e):
    store = synthetic_dense_store(e.total_vocab, 7, max_set=e.lma.max_set)
    lengths = np.asarray(store.lengths).copy()
    lengths[::9] = 0                                  # fallback rows
    sets = np.asarray(store.sets)
    return ({"store_sets": jnp.asarray(sets),
             "store_lengths": jnp.asarray(lengths)},
            buffers_from_numpy({"store_sets": sets, "store_lengths": lengths},
                               device="cpu"))


def _model_case(case: str):
    """(reference config, port config, numpy batch, buffers both ways)."""
    jbase, tbase = jget("gat-cora").make_smoke(), tget("gat-cora").make_smoke()
    bufs = ({}, {})
    if case == "molecule":
        kw = dict(readout="mean", n_classes=6, d_in=8)
        batch = jgraph.molecule_batch(8, 10, 20, 8, 6, seed=0)
    elif case == "block":
        kw = {}
        g = jgraph.sbm_graph(500, 3000, 16, 5, seed=1)
        block = jgraph.NeighborSampler(g, (5, 3), seed=0).sample(
            np.arange(16))
        max_nodes = 16 * (1 + 5 + 15) + 8
        max_edges = 16 * (5 + 15) + max_nodes + 8
        batch = jgraph.pad_block(block, max_nodes, max_edges)
        batch["edge_mask"] = np.arange(max_edges) < len(block["src"])
        batch.pop("n_nodes")
    else:
        g = jgraph.sbm_graph(120, 400, 16, 5, seed=2)
        batch = {"features": g.features, "src": g.src, "dst": g.dst,
                 "labels": g.labels, "label_mask": g.train_mask}
        kw = {}
        if case in ("lma", "full"):
            je = jembedding(case, (120,), 16, max_set=8) if case == "lma" \
                else jembedding(case, (120,), 16)
            te = embedding_of_kind(case, (120,), 16, max_set=8) \
                if case == "lma" else embedding_of_kind(case, (120,), 16)
            assert dataclasses.asdict(je) == dataclasses.asdict(te)
            batch["node_ids"] = np.arange(120, dtype=np.int32)[::-1].copy()
            del batch["features"]
            if case == "lma":
                bufs = _lma_buffers(je)
            jcfg = dataclasses.replace(jbase, node_id_embedding=je)
            tcfg = dataclasses.replace(tbase, node_id_embedding=te)
            return jcfg, tcfg, batch, bufs
    return (dataclasses.replace(jbase, **kw), dataclasses.replace(tbase, **kw),
            batch, bufs)


def _jinit(jcfg, seed=0):
    """Parameters in the reference's tree, drawn by numpy (N(0, 1/n) for a
    leaf of n rows; jax's random ops would compile one at a time)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jgnn.init(jax.random.key(0), jcfg))
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.normal(size=s.shape)
                               / np.sqrt(s.shape[0])).astype(s.dtype)),
        shapes)


def _port_model(jcfg, tcfg, seed=0):
    jparams = _jinit(jcfg, seed)
    model = tgnn.init(tcfg, device="cpu")
    model.load_state_dict(gnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    return jparams, model


def _jbatch(batch, jbufs):
    out = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in batch.items()}
    if jbufs:
        out["buffers"] = jbufs
    return out


def _tbatch(batch):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


def _grad_leaves(grads, prefix=""):
    out = {}
    for k, v in grads.items():
        if isinstance(v, dict):
            out.update(_grad_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """The reference's logits, loss, metrics and gradients of a case (one
    jitted program each, so that a case compiles once)."""
    jcfg, _, batch, (jbufs, _) = _model_case(case)
    jparams = _jinit(jcfg)
    jb = _jbatch(batch, jbufs)
    static = {k: v for k, v in jb.items() if not hasattr(v, "shape")}
    arrays = {k: v for k, v in jb.items() if hasattr(v, "shape")}

    def run(p, b):
        b = dict(b, **static)
        out = jax.value_and_grad(lambda p: jgnn.loss_fn(p, jcfg, b),
                                 has_aux=True)(p)
        return out, jgnn.forward(p, jcfg, b)
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jparams, arrays))


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("case", ["node", "molecule", "block", "lma",
                                  "full"])
def test_model_matches_reference(case, chunk):
    jcfg, tcfg, batch, (jbufs, tbufs) = _model_case(case)
    _, model = _port_model(jcfg, tcfg)
    ((jl, jm), jg), want = _reference(case)
    tb = _tbatch(batch)
    loss, met = tgnn.loss_fn(model, tb, tbufs, chunk)
    loss.backward()
    with torch.no_grad():
        got = model(tb, tbufs, chunk)
    assert got.shape == want.shape
    assert _rel(got, want) <= OUT_TOL
    np.testing.assert_allclose(float(loss), float(jl), rtol=OUT_TOL)
    assert float(met["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-7)
    want_g = _grad_leaves(jg)
    got_g = {}
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        if name.endswith(".weight"):
            name, g = name[:-len("weight")] + "kernel", g.T
        got_g[name] = g
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        assert _rel(got_g[k], w) <= GRAD_TOL, k


# ------------------------------------------------------------ the Trainer

def _ref_state(jt) -> dict:
    tree = state_from_jax(jax.tree_util.tree_map(np.asarray, jt._state()))
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


@pytest.mark.parametrize("case", ["node", "lma"])
def test_adam_trainer_steps_match_reference(case):
    """Five Adam steps at the arch's lr through both Trainers, each from the
    reference's state; with the LMA table its pool on lazy row-wise Adam
    (the sparse capture) on both sides."""
    jcfg, tcfg, batch, (jbufs, tbufs) = _model_case(case)
    jparams, model = _port_model(jcfg, tcfg, seed=3)
    arch_j, arch_t = jget("gat-cora"), tget("gat-cora")
    assert arch_j.learning_rate == arch_t.learning_rate == LR
    jb = _jbatch(batch, jbufs)
    jt = JTrainer(JTrainerConfig(total_steps=0, log_every=0),
                  lambda p, b: jgnn.loss_fn(p, jcfg, b), jparams,
                  jlaunch.make_optimizer(arch_j), lambda step: jb)
    tt = Trainer(TrainerConfig(total_steps=0, log_every=0),
                 lambda m, b: tgnn.loss_fn(m, b, tbufs), model,
                 tlaunch.make_optimizer(arch_t), lambda step: batch,
                 device="cpu")
    assert jt.sparse_grads == tt.sparse_grads == (case == "lma")
    losses = []
    for s in range(1, 6):
        flat = _ref_state(jt)                        # the state before s
        tt.params = _load(tt.params, _restored(tt.params, flat, "params"),
                          "params")
        tt.opt_state = _load(tt.opt_state,
                             _restored(tt.opt_state, flat, "opt_state"),
                             "opt_state")
        tt.step = s - 1
        jt.cfg.total_steps = tt.cfg.total_steps = s
        losses.append(jt.fit(log=lambda _: None)["loss"])
        loss = tt.fit(log=lambda _: None)["loss"]
        np.testing.assert_allclose(loss, losses[-1], rtol=1e-6)
        want = _ref_state(jt)
        got = {k: _host(v) for k, v in _flatten(tt._state()).items()}
        for k in (k for k in want if k.startswith("params/")):
            diff = np.abs(got[k] - want[k])
            loose = diff > GRAD_TOL
            assert loose.mean() <= SIGN_SHARE, (s, k, loose.mean())
            assert (diff <= 2 * LR + GRAD_TOL).all(), (s, k,
                                                       float(diff.max()))
    assert losses[-1] < losses[0], losses
    if case == "lma":
        assert tt.params["node_embed.memory"].grad is None


# ------------------------------------------------------------ the launcher

def test_launcher_family_dispatch():
    """``gnn`` is refused with the reference's words; ``lm`` trains its
    smoke config on bigram tokens, min(batch, 16) x 64 a step."""
    with pytest.raises(SystemExit, match="use examples/ for family gnn"):
        tlaunch.main(["--arch", "gat-cora", "--device", "cpu", "--steps",
                      "1"])
    out = tlaunch.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                        "--steps", "3", "--batch", "32"])
    assert out["train"]["step"] == 3
    assert np.isfinite(out["train"]["loss"])
    assert out["train"]["lookups_per_sec"] == pytest.approx(
        out["train"]["steps_per_sec"] * 16 * 64)
    assert "eval" not in out
