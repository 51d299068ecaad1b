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


# ------------------------------------------------------- the 'data' axis

def local(x, mesh):
    """A numpy array's share on this rank (the Trainer's split)."""
    from repro_torch.dist.sharded_memory import local_batch
    return local_batch(x, mesh) if mesh is not None else x


def data_lookups(mesh, cases: list) -> dict:
    """Every case through ``embed_fields`` on this rank's share of the ids
    under psum and all_to_all: the share's output, this rank's slab
    gradient of ``sum(out * g)`` over the share, and the strategy that
    ran."""
    res = {}
    for c in cases:
        table = table_of(c["name"])
        ids = torch.from_numpy(local(c["ids"], mesh))
        g = torch.from_numpy(local(c["g"], mesh))
        for strategy in ("psum", "all_to_all"):
            params, bufs = port_state(c, mesh)
            params["memory"].requires_grad_()
            with forced(strategy), use_mesh(mesh):
                out = embed(table, params, bufs, ids)
                (out * g).sum().backward()
                ran = get_scheme(table.config.kind).sharded_lookup(
                    table.config, params, bufs, ids.reshape(-1), mesh)
            key = (c["name"], strategy)
            res[key + ("out",)] = out.detach().numpy()
            res[key + ("grad",)] = params["memory"].grad.numpy()
            res[key + ("ran",)] = ran.strategy
    return res


def step_train(mesh, name: str, algo: str, strategy, steps: int = 10,
               device: str = "cpu"):
    """``steps`` of a sparse optimizer on one table's pool through the
    guarded train step (``guard.make_step``) on this rank's share of each
    batch, the reference test's mean-squared loss, on ``device``; one
    process when ``mesh`` is None.  -> (losses, the pool or this rank's
    slab)."""
    from repro_torch.dist.sharded_memory import _batch_axes
    from repro_torch.resilience.guard import make_step

    table = table_of(name, (512,))
    c = case(name)
    if "store_sets" in c:
        c["store_sets"], c["store_lengths"] = store_arrays(512)
    params, bufs = port_state(c, mesh)
    bufs = {k: v.to(device) for k, v in bufs.items()}
    params["memory"] = params["memory"].to(device)
    p = params["memory"].requires_grad_()
    opt = sparse_optimizer(algo)
    state = opt.init({"memory": p})

    def loss_fn(_, b):
        e = table.embed(params, bufs, 0, b["ids"])
        return torch.mean((e - b["y"]) ** 2), {}

    step = make_step(loss_fn, opt, sparse_grads=True)
    losses = []
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with forced(strategy), ctx:
        for s in range(steps):
            ids, y = train_batch(s)
            split = bool(_batch_axes(mesh, ids.shape[0]))
            b = {"ids": torch.from_numpy(local(ids, mesh)).to(device),
                 "y": torch.from_numpy(local(y, mesh)).to(device)}
            state, loss, ok, _ = step(None, {"memory": p}, state, b,
                                      split=split)
            assert ok
            losses.append(float(loss))
    return np.asarray(losses), p.detach().cpu().numpy().copy()


def card_step(mesh, runs: list, steps: int) -> dict:
    """``step_train`` of each run on this rank's device (the card test's
    (2, 2) step, on the card and on the CPU)."""
    return {run: step_train(mesh, *run, steps=steps,
                            device=str(mesh.device)) for run in runs}


def data_all(mesh, cases: list, runs: list, np_params: dict,
             np_bufs: dict) -> dict:
    """One spawn's work on a (data, model) mesh: the lookups, the sparse
    runs and the small DLRM's Trainer."""
    return {"lookups": data_lookups(mesh, cases),
            "train": {run: step_train(mesh, *run) for run in runs},
            "dlrm": dlrm_train(mesh, np_params, np_bufs),
            "mesh": (mesh.data, mesh.model, mesh.data_rank, mesh.rank,
                     mesh.world_rank)}


# ------------------------------------------------- freq and the CSR store

FREQ_HOT = 32


def freq_table() -> EmbeddingTable:
    return EmbeddingTable(get_scheme("freq").build_config(
        VOCABS, DIM, BUDGET, seed=9, hot_k=FREQ_HOT))


def freq_counts(seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).zipf(1.3, sum(VOCABS)).astype(
        np.int64)


def freq_lookups(mesh, c: dict) -> dict:
    """freq's lookup of ``c``'s field ids (hot ids from ``freq_counts``)
    under each strategy, or on one process when ``mesh`` is None: the
    output, this rank's slab gradient of ``sum(out * g)`` and the strategy
    that ran."""
    table = freq_table()
    ids, g = torch.from_numpy(c["ids"]), torch.from_numpy(c["g"])
    res = {}
    for strategy in STRATEGIES if mesh is not None else (None,):
        params = {"memory": row_slab(torch.from_numpy(c["memory"].copy()),
                                     mesh).requires_grad_()}
        bufs = table.make_buffers(freq_counts(), mesh=mesh, device="cpu")
        ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
        with forced(strategy), ctx:
            out = table.embed_fields(params, bufs, ids)
            (out * g).sum().backward()
            ran = (get_scheme("freq").sharded_lookup(
                table.config, params, bufs, ids.reshape(-1), mesh).strategy
                if mesh is not None else "none")
        res[(strategy, "out")] = out.detach().numpy()
        res[(strategy, "grad")] = params["memory"].grad.numpy()
        res[(strategy, "ran")] = ran
        res[(strategy, "hot")] = bufs["freq_hot_ids"].numpy()
    return res


def csr_arrays(n: int = sum(VOCABS), seed: int = 6) -> dict:
    """A CSR D' store as numpy: sample ids >= 2^31 among them, empty sets,
    sets of one and sets longer than MAX_SET."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 2 * MAX_SET + 1, n).astype(np.int32)
    lengths[::7] = 0
    lengths[1::7] = 1
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lengths, out=offsets[1:])
    flat = rng.integers(0, 1 << 32, int(offsets[-1]), dtype=np.uint64
                        ).astype(np.uint32)
    return {"store_flat": flat, "store_offsets": offsets,
            "store_lengths": lengths}


def dense_of(csr: dict) -> dict:
    """The same store in the dense form (PAD past each set's end)."""
    from repro_torch.core.signatures import densify_store
    from repro_torch.core.signatures import SignatureStore
    st = densify_store(SignatureStore(csr["store_flat"], csr["store_offsets"],
                                      csr["store_lengths"]), MAX_SET,
                       device="cpu")
    return {"store_sets": st.sets.numpy().view(np.uint32),
            "store_lengths": st.lengths.numpy()}


def csr_lookups(mesh, c: dict, csr: dict) -> dict:
    """Under each strategy, on this rank's device: the CSR store's set rows
    through ``sharded_csr_set_lookup``, and the LMA lookup of ``c``'s field
    ids through the sharded CSR store and through the sharded dense
    store."""
    from repro_torch.dist.sharded_memory import sharded_csr_set_lookup

    dev = mesh.device
    table = table_of("lma")
    ids = torch.from_numpy(c["ids"]).to(dev)
    gids = (ids + torch.tensor([0, VOCABS[0]], dtype=torch.int32,
                               device=dev)).reshape(-1)
    cbufs = buffers_from_numpy(csr, device=dev, mesh=mesh)
    dbufs = buffers_from_numpy(dense_of(csr), device=dev, mesh=mesh)
    res = {"keys": sorted(cbufs)}
    for strategy in STRATEGIES:
        params = {"memory": row_slab(torch.from_numpy(c["memory"].copy()),
                                     mesh).to(dev)}
        with forced(strategy), use_mesh(mesh), torch.no_grad():
            res[(strategy, "sets")] = tuple(
                x.cpu().numpy() for x in sharded_csr_set_lookup(
                    cbufs["store_flat_sh"], cbufs["store_offsets_sh"],
                    cbufs["store_lengths"], gids, MAX_SET, mesh))
            res[(strategy, "csr")] = table.embed_fields(params, cbufs,
                                                        ids).cpu().numpy()
            res[(strategy, "dense")] = table.embed_fields(params, dbufs,
                                                          ids).cpu().numpy()
            res[(strategy, "ran")] = get_scheme("lma").sharded_lookup(
                table.config, params, cbufs, gids, mesh).strategy
    return res


# ------------------------------------------------- the exchange guard

def guard_run(mesh, spec: str, c: dict) -> dict:
    """Under the fault ``spec`` (a chunk fault), the ExchangeGuard walks the
    ladder on a probe (hashed_elem's lookup of ``c``'s ids, pinned through
    ``FORCED``); then 10 sparse Adagrad steps on the cost model's (auto)
    strategies and 10 pinned to psum, the injector still armed.  -> the
    guard's verdict, the demotions, the health counters, every probe's
    output and both training runs."""
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience.exchange_guard import ExchangeGuard
    from repro_torch.resilience.health import Health

    table = table_of("hashed_elem")
    ids = torch.from_numpy(c["ids"])
    params, _ = port_state(c, mesh)
    probes = {}

    def probe(name):
        with forced(name), use_mesh(mesh), torch.no_grad():
            out = table.embed_fields(params, {}, ids)
        probes.setdefault(name, out.numpy())
        return out

    exl.reset_demotions()
    flt.install(flt.FaultInjector(spec))
    try:
        health = Health()
        final = ExchangeGuard(probe, health=health,
                              log=lambda _: None).validate()
        demoted = dict(exl.DEMOTED)
        auto = step_train(mesh, "hashed_elem", "adagrad", None)
        pinned = step_train(mesh, "hashed_elem", "adagrad", "psum")
        with use_mesh(mesh):
            after = (exl.resolve_exchange(mesh, 4096, DIM).name,
                     exl.resolve_update_exchange(mesh).name)
    finally:
        flt.install(None)
        exl.reset_demotions()
    return {"final": final, "demoted": demoted, "after": after,
            "health": health.as_dict(), "probes": probes, "auto": auto,
            "pinned": pinned}


def guard_all(mesh, specs: list, c: dict) -> dict:
    return {spec: guard_run(mesh, spec, c) for spec in specs}


# ------------------------------------------------ checkpoints under a mesh
# (the resident CTR smoke problem of tests/test_torch_durable_trainer.py:
# a hashed_row pool of 4,096 slots, Adagrad, a squared-error loss)

CTR_VOCAB, CTR_D, CTR_M = 512, 16, 4096


def ctr_batch(step: int) -> dict:
    Y = np.random.default_rng(1).normal(size=(CTR_VOCAB, CTR_D)
                                        ).astype(np.float32)
    ids = np.random.default_rng(step).integers(0, CTR_VOCAB, (64,), np.int32)
    return {"ids": ids, "y": Y[ids]}


def ctr_trainer(mesh, init: np.ndarray, ckpt_dir: str, total: int,
                inj=None, every: int = 4, delta: bool = True):
    """A Trainer of the CTR problem from the pool ``init`` (this rank's
    slab of it under a mesh)."""
    from repro_torch.train.trainer import Trainer, TrainerConfig

    table = EmbeddingTable(get_scheme("hashed_row").build_config(
        (CTR_VOCAB,), CTR_D, CTR_M, seed=3))
    bufs = table.make_buffers(None, device="cpu")

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = torch.nn.ParameterDict(
                {"memory": row_slab(torch.from_numpy(init.copy()), mesh)})

    def loss_fn(model, b):
        e = table.embed(dict(model.embedding), bufs, 0, b["ids"])
        return torch.mean((e - b["y"]) ** 2), {}

    cfg = TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                        ckpt_every=every, keep=3, log_every=0,
                        ckpt_delta=delta, max_consecutive_skips=1,
                        rollback_on_quarantine=True)
    return Trainer(cfg, loss_fn, Model(), opt_lib.adagrad(0.1), ctr_batch,
                   device="cpu", faults=inj)


def host_state(tr) -> dict:
    """A Trainer's durable state as host arrays by checkpoint path (a
    rank's slabs under a mesh)."""
    from repro_torch.checkpoint.manager import _flatten, _host
    return {k: _host(v) for k, v in _flatten(tr._state()).items()}


def ckpt_resume(mesh, init: np.ndarray, ckpt_dir: str, total: int) -> dict:
    """Resume the CTR problem's checkpoint in ``ckpt_dir`` and train to
    ``total``: -> the resumed step and the final state."""
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        tr = ctr_trainer(mesh, init, ckpt_dir, total)
        out = tr.fit(log=lambda _: None)
    return {"resumed": out["resumed_step"], "step": out["step"],
            "state": host_state(tr)}


def ckpt_mesh(mesh, init: np.ndarray, root: str, jdir: str,
              spec: str) -> dict:
    """On a (1, P) mesh: (a) 4 steps saved at step 4, the directory copied
    (``root/at4``), then on to 8; (b) the reference's checkpoint in
    ``jdir`` resumed to 8; (c) a chaos soak of 24 steps under ``spec`` and
    its clean run."""
    import os
    import shutil

    from repro_torch.dist import collectives as col
    from repro_torch.resilience import chaos
    from repro_torch.resilience import faults as flt

    out = {}
    run = os.path.join(root, "run")
    with use_mesh(mesh):
        tr = ctr_trainer(mesh, init, run, 4)
        tr.fit(log=lambda _: None)
        if mesh.world_rank == 0:
            shutil.copytree(run, os.path.join(root, "at4"))
        col.barrier(mesh)
        tr.cfg.total_steps = 8
        tr.fit(log=lambda _: None)
        out["uninterrupted"] = host_state(tr)
    out["jax"] = ckpt_resume(mesh, init, jdir, 8)
    made = []

    def factory(inj):
        made.append(ctr_trainer(mesh, init, os.path.join(root, "chaos"), 24,
                                inj))
        return made[-1]

    with use_mesh(mesh):
        res = chaos.run_chaos(factory, spec, seed=21)
        flt.install(None)
        clean = ctr_trainer(mesh, init, os.path.join(root, "clean"), 24)
        clean.fit(log=lambda _: None)
    out["chaos"] = {"res": {k: v for k, v in res.items()
                            if isinstance(v, (int, float, bool))},
                    "state": chaos.durable_state(made[-1]),
                    "clean": chaos.durable_state(clean),
                    "incarnations": len(made)}
    return out
