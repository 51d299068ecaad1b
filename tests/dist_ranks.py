"""Rank functions of the port's distributed tests (``test_torch_dist_*``),
run by ``repro_torch.dist.collectives.run_ranks`` in spawned processes.

Not a test module (no ``test_`` prefix) and it imports no JAX: a spawned
rank imports this file by name.  Every case is built here from numpy and a
seed, so the parent (which holds the JAX reference) and every rank see the
same arrays.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.convert import buffers_from_numpy, params_from_jax
from repro_torch.dist import exchange as exl
from repro_torch.dist.context import use_mesh
from repro_torch.dist.sharded_memory import sharded_set_lookup
from repro_torch.dist.sharding import row_slab
from repro_torch.embed import EmbeddingTable, get_scheme
from repro_torch.models.recsys import RecsysConfig
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import sparse as sp

VOCABS = (200, 312)            # 512 values: the store's rows divide by 4
DIM, BUDGET, MAX_SET = 16, 4096, 16
STRATEGIES = ("psum", "ring", "all_to_all")
# scheme cases: (kind, build_config keywords)
KINDS = {
    "lma": ("lma", {"seed": 3, "striped": True, "max_set": MAX_SET}),
    "lma_flat": ("lma", {"seed": 3, "striped": False, "max_set": MAX_SET}),
    "hashed_elem": ("hashed_elem", {"seed": 5}),
    "hashed_row": ("hashed_row", {"seed": 5}),
}


def store_arrays(n_values: int, seed: int = 2):
    """A dense D' store as numpy (uint32 sets, PAD tails; int32 lengths)
    with very sparse rows (support 0 and 1), so the fallback runs."""
    rng = np.random.default_rng(seed)
    sets = rng.integers(0, 64, (n_values, MAX_SET)).astype(np.uint32)
    lengths = rng.integers(0, MAX_SET + 1, n_values).astype(np.int32)
    lengths[::9] = 0
    lengths[1::9] = 1
    sets[np.arange(MAX_SET)[None, :] >= lengths[:, None]] = 0xFFFFFFFF
    return sets, lengths


def case(name: str, seed: int = 0, batch: int = 24, fields: bool = True):
    """-> dict of numpy arrays for one scheme case: the pool, the store
    (lma), ids (field ids [batch, 2], or table 0's [batch] when ``fields``
    is False) and a cotangent for the lookup."""
    kind, _ = KINDS[name]
    rng = np.random.default_rng(seed)
    shape = (batch, len(VOCABS)) if fields else (batch,)
    vocab = np.asarray(VOCABS) if fields else VOCABS[0]
    out = {"name": name,
           "memory": rng.normal(0, 0.1, BUDGET).astype(np.float32),
           "ids": (rng.integers(0, 1 << 20, shape) % vocab).astype(np.int32),
           "g": rng.normal(0, 1, shape + (DIM,)).astype(np.float32)}
    if kind == "lma":
        out["store_sets"], out["store_lengths"] = store_arrays(sum(VOCABS))
    return out


def table_of(name: str, vocabs=VOCABS) -> EmbeddingTable:
    kind, kw = KINDS[name]
    return EmbeddingTable(get_scheme(kind).build_config(vocabs, DIM, BUDGET,
                                                        **kw))


def port_state(c: dict, mesh=None):
    """(params, buffers) of a case on the CPU, a rank's share under a
    mesh."""
    mem = torch.from_numpy(c["memory"].copy())
    params = {"memory": row_slab(mem, mesh)}
    bufs = {}
    if "store_sets" in c:
        bufs = buffers_from_numpy({"store_sets": c["store_sets"],
                                   "store_lengths": c["store_lengths"]},
                                  device="cpu", mesh=mesh)
    return params, bufs


@contextlib.contextmanager
def forced(strategy):
    prev = exl.FORCED
    exl.FORCED = strategy
    try:
        yield
    finally:
        exl.FORCED = prev


# ------------------------------------------------------------------ lookups

def embed(table, params, bufs, ids):
    """Field ids [B, F] through ``embed_fields``, table 0's [B] through
    ``embed`` (the reference's table API takes the same arguments)."""
    if ids.ndim == 2:
        return table.embed_fields(params, bufs, ids)
    return table.embed(params, bufs, 0, ids)


def lookups(mesh, cases: list) -> dict:
    """Every case through ``embed_fields`` under the mesh, for each
    strategy (the kernels' plain versions run on the CPU): the output, this
    rank's slab gradient of ``sum(out * g)`` and the strategy the scheme's
    sharded lookup took; and the D' store's set rows through
    ``sharded_set_lookup``.  -> {key: numpy array or strategy name}."""
    res = {}
    for c in cases:
        table = table_of(c["name"])
        ids = torch.from_numpy(c["ids"])
        g = torch.from_numpy(c["g"])
        for strategy in STRATEGIES:
            params, bufs = port_state(c, mesh)
            params["memory"].requires_grad_()
            with forced(strategy), use_mesh(mesh):
                out = embed(table, params, bufs, ids)
                (out * g).sum().backward()
                # every id is a valid global id: the vocabularies sum to
                # the store's rows
                ran = get_scheme(table.config.kind).sharded_lookup(
                    table.config, params, bufs, ids.reshape(-1), mesh)
            key = (c["name"], strategy)
            res[key + ("out",)] = out.detach().numpy()
            res[key + ("grad",)] = params["memory"].grad.numpy()
            res[key + ("ran",)] = ran.strategy
        if "store_sets" in c and ids.dim() == 2:
            _, bufs = port_state(c, mesh)
            gids = (ids + torch.tensor([0, VOCABS[0]], dtype=torch.int32)
                    ).reshape(-1)
            for strategy in STRATEGIES:
                for buf in ("store_sets", "store_lengths"):
                    with forced(strategy):
                        res[(c["name"], strategy, buf)] = \
                            sharded_set_lookup(bufs[buf], gids, mesh).numpy()
                res[(c["name"], strategy, "partial_sum")] = \
                    partial_sum_sets(bufs["store_sets"], gids, mesh,
                                     strategy).numpy()
    return res


def partial_sum_sets(sets, gids, mesh, strategy):
    """The store's set rows through ``Exchange.partial_sum_lookup`` (the
    general set gather) with this rank's masked gather as ``local_fn``;
    the chunked strategies assemble per-rank chunks, then all-gather."""
    from repro_torch.dist import collectives as col

    ex = exl.get_exchange(strategy)
    idx = gids if strategy == "psum" else exl.chunk_for_rank(
        gids, mesh.rank, mesh.model)
    rows, = ex.partial_sum_lookup(
        lambda q: (exl.local_gather(sets, q, mesh),), idx, mesh)
    if strategy == "psum":
        return rows
    return col.all_gather(rows, mesh).reshape(-1, sets.shape[1])


# -------------------------------------------------------- sparse training

def sparse_optimizer(algo: str) -> opt_lib.Optimizer:
    return {"adagrad": lambda: sp.sparse_adagrad(0.1, eps=1e-8),
            "sgd": lambda: sp.sparse_sgd(0.1, momentum=0.9),
            "adam": lambda: sp.sparse_rowwise_adam(0.01)}[algo]()


def train_batch(step: int):
    r = np.random.default_rng(step)
    return (r.integers(0, 512, 64).astype(np.int32),
            r.normal(size=(64, DIM)).astype(np.float32))


def sparse_train(mesh, name: str, algo: str, strategy, steps: int = 10):
    """``steps`` of a sparse optimizer on one table's pool (the reference
    test's mean-squared loss), under the mesh when given and with
    ``strategy`` pinning the lookup and update exchanges.  -> (losses, the
    pool or this rank's slab, the SparseGrad layout)."""
    table = table_of(name, (512,))
    c = case(name)
    if "store_sets" in c:
        c["store_sets"], c["store_lengths"] = store_arrays(512)
    params, bufs = port_state(c, mesh)
    p = params["memory"].requires_grad_()
    opt = sparse_optimizer(algo)
    state = opt.init({"memory": p})
    losses, layout = [], None
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with forced(strategy), ctx:
        for s in range(steps):
            ids, y = (torch.from_numpy(a) for a in train_batch(s))
            with sp.capture() as cap:
                loss = torch.mean((table.embed(params, bufs, 0, ids) - y) ** 2)
                loss.backward()
            grads = cap.grads({"memory": p})
            g = grads["memory"]
            layout = (g.unique, g.buckets, tuple(g.dense_shape))
            u, state = opt.update(grads, state, {"memory": p})
            opt_lib.apply_updates({"memory": p}, u)
            losses.append(float(loss.detach()))
    return np.asarray(losses), p.detach().numpy().copy(), layout


def sparse_train_all(mesh, runs: list) -> dict:
    return {run: sparse_train(mesh, *run) for run in runs}


# ------------------------------------------------------------- small DLRM

DLRM_VOCABS = (100, 200, 212)


def dlrm_config(kind: str = "lma") -> RecsysConfig:
    e = get_scheme(kind).build_config(DLRM_VOCABS, DIM, BUDGET, seed=3,
                                      striped=True, max_set=MAX_SET)
    return RecsysConfig(name="dlrm-dist-test", model="dlrm", embedding=e,
                        n_dense=4, bot_mlp=(8, DIM), top_mlp=(8, 1))


def dlrm_batch(step: int, batch: int = 32) -> dict:
    r = np.random.default_rng(100 + step)
    return {"dense": r.normal(size=(batch, 4)).astype(np.float32),
            "sparse": (r.integers(0, 1 << 20, (batch, 3))
                       % np.asarray(DLRM_VOCABS)).astype(np.int32),
            "label": (r.random(batch) < 0.3).astype(np.float32)}


def dlrm_train(mesh, np_params: dict, np_bufs: dict, steps: int = 5):
    """The port's Trainer, ``steps`` steps of the adagrad arm (the pool on
    sparse Adagrad) on the small DLRM, under the mesh when given.  -> (the
    losses, every parameter as numpy: the pool a rank's slab)."""
    from repro_torch.models import recsys
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dlrm_config()
    model = recsys.init(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(params_from_jax(np_params, cfg, device="cpu",
                                          mesh=mesh))
    bufs = buffers_from_numpy(np_bufs, device="cpu", mesh=mesh)
    opt = opt_lib.multi_transform([(r"(^|\.)memory$", sp.sparse_adagrad(0.01))],
                                  default=opt_lib.adagrad(0.01))
    tr = Trainer(TrainerConfig(total_steps=0, log_every=1),
                 lambda m, b: recsys.loss_fn(m, b, bufs), model, opt,
                 dlrm_batch, device="cpu")
    logged, losses = [], []
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        for s in range(1, steps + 1):
            tr.cfg.total_steps = s
            losses.append(tr.fit(log=logged.append)["loss"])
    return {"losses": np.asarray(losses), "logged": len(logged),
            "sparse": tr.sparse_grads,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.named_parameters()}}
