"""Training launcher for the recsys archs (port of ``repro.launch.train``'s
main path): synthetic CTR (or DIN behaviour) data with planted semantics,
the scheme's buffers (the D' signature store for lma, observed id counts
for freq), the arch's optimizer with the pool on its lazy sparse form, the
:class:`~repro_torch.train.trainer.Trainer`, then a streaming AUC eval.  It
is the port's form of ``examples/train_lma_dlrm.py``: run it once with lma
and once with hashed_elem to compare the two at an equal budget.  A pool
over ``--tier-budget-mb`` trains through the tiered store
(``repro_torch.tier``: HBM-hot / host-cold, bit-identical to the resident
run), updated densely, and evaluates through the full pool.  An ``lm``
arch trains its smoke config on bigram tokens (``LMGenerator``, min(batch,
16) sequences of 64) with the arch's optimizer (deepseek-v3-671b's is
``adafactor``), as the reference's launcher does, and under an installed
mesh trains its ``lm_rules`` blocks on the batch's 'data' share; a
``gnn`` arch is refused with the reference's words (the GAT trains through
``repro_torch.models.gnn`` and the Trainer directly, as ``chip_smoke.py``
drives it).

  python -m repro_torch.launch.train --arch lma-dlrm-criteo --steps 300
  python -m repro_torch.launch.train --arch lma-dlrm-criteo \\
      --embedding-kind hashed_elem --steps 300
  python -m repro_torch.launch.train --arch lma-dlrm-avazu --steps 300
  python -m repro_torch.launch.train --device cpu --steps 20 --batch 64
  python -m repro_torch.launch.train --arch xdeepfm --smoke --device cpu \\
      --steps 20 --batch 64
  python -m repro_torch.launch.train --arch din --smoke --device cpu \\
      --steps 20 --batch 64
  python -m repro_torch.launch.train --arch dcn-v2 --smoke \\
      --embedding-kind freq --device cpu --steps 20 --batch 64
  python -m repro_torch.launch.train --arch lma-dlrm-criteo --steps 300 \\
      --ckpt-dir build/ckpt --ckpt-delta --faults nan_grad@50,rot_row@120:8
  python -m repro_torch.launch.train --arch din --tier-budget-mb 40 \\
      --batch 4 --steps 300
  python -m repro_torch.launch.train --arch tinyllama-1.1b --device cpu \\
      --steps 20
  python -m repro_torch.launch.train --arch deepseek-v3-671b --device cpu \\
      --steps 2

``--embedding-kind`` takes any registered scheme (``list_schemes``): full,
hashed_elem, hashed_row, qr, lma, md, freq.  Durability follows the
reference's launcher: ``--ckpt-dir`` (saves every 100 steps and on
SIGTERM/SIGINT; a rerun resumes), ``--ckpt-delta`` (or
``REPRO_CKPT_DELTA=1``) and ``--ckpt-compact-every``, ``--faults`` /
``--fault-seed`` (``repro_torch.resilience.faults``) and ``--no-guard``
(or ``REPRO_GUARD_STEP=0``).  The health counters follow the result.
``--tier-budget-mb`` (or ``REPRO_TIER_BUDGET_MB``) bounds the pool's device
footprint: the compact value pool, one mirror per optimizer moment and each
leaf's stage region (``_maybe_tier``).

It runs on the card unless ``--device cpu`` is given (with ``src`` on
``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import os
import signal

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.signatures import build_signature_store, densify_store
from repro_torch.data.metrics import StreamingEval
from repro_torch.data.synthetic_ctr import (CTRGenerator, CTRSpec,
                                            DINGenerator, DINSpec)
from repro_torch.device import resolve_device
from repro_torch.embed import backends as bke
from repro_torch.embed import get_scheme, make_buffers
from repro_torch.models import recsys
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import sparse as sparse_lib
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_optimizer(arch, sparse_ok: bool = True) -> opt_lib.Optimizer:
    """The arch's optimizer, as the reference's ``make_optimizer`` builds it:
    with ``sparse_ok`` and the ``REPRO_SPARSE_GRADS`` gate on, the pool
    (``memory``) routes to the sparse optimizer by name and every other
    parameter to the dense one -- Adagrad and sparse Adagrad; momentum SGD
    (0.9) and lazy momentum SGD; Adam and lazy row-wise Adam -- else the
    dense optimizer takes every parameter (a tiered pool, whose moments
    mirror the compact pool).  Adafactor has no sparse partner, so it takes
    every parameter, the pool included (a sparse gradient densified).
    Whether the pool's gradient is sparse is the Trainer's choice
    (``sparse_grads``); the sparse optimizer takes either form."""
    lr = arch.learning_rate
    dense, sparse = {
        "adagrad": (opt_lib.adagrad, sparse_lib.sparse_adagrad),
        "sgd": (lambda lr: opt_lib.sgd(lr, momentum=0.9),
                lambda lr: sparse_lib.sparse_sgd(lr, momentum=0.9)),
        "adam": (opt_lib.adam, sparse_lib.sparse_rowwise_adam),
        "adafactor": (opt_lib.adafactor, None),
    }[arch.optimizer]
    if sparse_ok and sparse_lib.sparse_enabled() and sparse is not None:
        return opt_lib.multi_transform([(r"(^|\.)memory$", sparse(lr))],
                                       default=dense(lr))
    return dense(lr)


def lookups_per_step(cfg, batch: int) -> int:
    """Embedding-row lookups one recsys step performs."""
    return batch * recsys.lookups_per_example(cfg)


# compact pool leaves the dense optimizer keeps per pool slot, besides the
# value pool itself (adam: mu + nu; adagrad: acc; momentum sgd: the trace)
MOMENT_LEAVES = {"adam": 2, "adagrad": 1, "sgd": 1}


def _maybe_tier(cfg, arch, model, bufs, batch_fn, budget_mb):
    """Tier the model's pool when it exceeds the per-device budget
    (``--tier-budget-mb`` / ``REPRO_TIER_BUDGET_MB``), as the reference's
    ``_maybe_tier`` does.

    The budget bounds the pool's whole device footprint: the compact value
    pool, one same-sized mirror per optimizer moment, and each leaf's stage
    region.  The staging capacity is one block per planned location element
    of one planned batch (the location shape is the same every step), so
    staging can never overflow mid-run; a budget the stage regions alone
    exhaust is refused.  The model's ``memory`` parameter becomes the
    compact pool.  -> ``(loss_fn, controller)``, ``(None, None)`` when the
    run stays resident.  The tiered loss peels the remap buffers out of the
    batch into the embedding buffers, the only change the model sees."""
    from repro_torch.tier import (BLOCK_DEFAULT, TieredStore, TierController,
                                  needs_tiering, split_batch, tier_split)
    e = cfg.embedding
    scheme = get_scheme(e.kind)
    if budget_mb is None or scheme.family != "memory":
        return None, None
    if cfg.model == "xdeepfm":
        # the remap buffers ride in the embedding buffers the linear pool
        # shares, so tiering the main pool would break the linear lookups
        print("tiering skipped: xdeepfm's dual memory pools stay resident")
        return None, None
    mem = model.embedding["memory"]
    m, itemsize = int(mem.shape[0]), mem.element_size()
    n_leaves = 1 + MOMENT_LEAVES[arch.optimizer]
    if not needs_tiering(m, itemsize, budget_mb, n_leaves=n_leaves):
        print(f"pool fits the {budget_mb} MB tier budget ({m} slots x "
              f"{n_leaves} leaves); untiered")
        return None, None
    block = BLOCK_DEFAULT
    while m % block:
        block //= 2
    offs = torch.as_tensor(e.table_offsets()[:-1], dtype=torch.int32,
                           device=mem.device)

    def plan_fn(batch):
        def ids(k):
            return torch.as_tensor(batch[k]).to(mem.device, torch.int32)
        if cfg.model == "din":
            g = torch.cat([ids("hist").reshape(-1), ids("target").reshape(-1)])
        else:
            g = (ids("sparse") + offs[None, :]).reshape(-1)
        return bke.global_locations(e, scheme, bufs, g)

    cap = min(int(plan_fn(batch_fn(0)).numel()), m // block)
    hot_slots, cold_slots = tier_split(m, budget_mb, itemsize, block,
                                       n_leaves=n_leaves, stage_blocks=cap)
    cap = min(cap, cold_slots // block)
    if hot_slots <= 0:
        raise SystemExit(
            f"--tier-budget-mb {budget_mb}: the {n_leaves} compact pool "
            f"leaves' stage regions alone ({cap} blocks x {block} slots "
            f"each) exhaust the budget -- raise the budget or shrink the "
            f"batch")
    store = TieredStore(mem, hot_slots, block=block, stage_blocks=cap)
    model.embedding["memory"] = torch.nn.Parameter(store.initial_compact())

    def tiered_loss(model, b):
        clean, tier = split_batch(b)
        return recsys.loss_fn(model, clean, {**bufs, **tier})

    dev_mb = n_leaves * store.compact_slots * itemsize / 2**20
    print(f"tiered memory pool: {m} slots -> {store.hot_slots} hot + "
          f"{m - store.hot_slots} cold, stage {store.stage_blocks} blocks "
          f"(block {block}; {n_leaves} leaves x {store.compact_slots} slots "
          f"= {dev_mb:.0f} MB on device, budget {budget_mb} MB)")
    return tiered_loss, TierController(store, batch_fn, plan_fn)


def _recsys_setup(arch, cfg, n_s: int, batch: int, device):
    """-> (generator, buffers, batch_fn, loss_fn).  Batches are host numpy
    arrays (the trainer moves them); the buffers go to ``device``.  Data
    preparation follows the scheme's ``buffer_source``, so a registered
    scheme's buffers build here without a kind check."""
    e = cfg.embedding
    if cfg.model == "din":
        gen = DINGenerator(DINSpec(n_items=e.vocab_sizes[0],
                                   hist_len=max(cfg.hist_len, 8),
                                   n_clusters=50, seed=0))
    else:
        gen = CTRGenerator(CTRSpec(n_fields=cfg.n_fields, n_dense=cfg.n_dense,
                                   vocab_sizes=e.vocab_sizes, seed=0))
    source = get_scheme(e.kind).buffer_source
    bufs = {}
    if source == "signatures":
        print(f"building D' ({n_s} rows)...")
        store = build_signature_store(gen.rows_for_signatures(n_s),
                                      e.total_vocab,
                                      max_per_value=e.lma.max_set)
        bufs = make_buffers(e, densify_store(store, e.lma.max_set,
                                             device=device))
    elif source == "id_counts":
        print(f"counting observed ids ({n_s} rows)...")
        counts = np.zeros(e.total_vocab, np.int64)
        for row in gen.rows_for_signatures(n_s):
            np.add.at(counts, np.asarray(row, np.int64), 1)
        bufs = make_buffers(e, counts, device=device)

    def batch_fn(step):
        return gen.batch(batch, step)

    def loss_fn(model, b):
        return recsys.loss_fn(model, b, bufs)

    return gen, bufs, batch_fn, loss_fn


def _lm_setup(cfg, batch: int):
    """The reference's smoke LM run: -> (batch_fn, loss_fn) over bigram
    tokens (``LMGenerator``, seed 0), min(batch, 16) sequences of 64."""
    from repro_torch.data.lm_data import LMGenerator
    from repro_torch.models import transformer
    gen = LMGenerator(cfg.vocab_size, seed=0)

    def batch_fn(step):
        return gen.batch(min(batch, 16), 64, step)

    def loss_fn(m, b):
        return transformer.loss_fn(m, cfg, b["tokens"], b["labels"])

    return batch_fn, loss_fn


def evaluate(model, gen, bufs, n_batches: int, device,
             params: dict | None = None) -> dict:
    """Streaming AUC / logloss / accuracy over held-out batches (every key
    of a batch but the label goes to the model); ``params`` (by name)
    stand in for the model's own, as a tiered run's full pool does."""
    ev = StreamingEval()
    with torch.no_grad():
        for i in range(n_batches):
            b = gen.batch(2048, 700_000 + i)
            x = {k: torch.from_numpy(v).to(device) for k, v in b.items()
                 if k != "label"}
            logits = (model(x, bufs) if params is None else
                      torch.func.functional_call(model, params, (x, bufs)))
            ev.add(b["label"], logits.cpu().numpy())
    return ev.compute()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lma-dlrm-criteo")
    ap.add_argument("--embedding-kind", default=None,
                    help="override the arch's embedding scheme (any "
                         "registered kind: full, hashed_elem, hashed_row, "
                         "qr, lma, md, freq)")
    ap.add_argument("--exchange", default=None,
                    choices=["psum", "ring", "all_to_all", "auto"],
                    help="pin the sharded lookup and update exchange "
                         "strategy (default: REPRO_DIST_EXCHANGE or the "
                         "cost model); only observable under a mesh")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n-signatures", type=int, default=10_000)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec, e.g. "
                         "'nan_grad@17,rot_row@40:8,slow_rank@55:0.5' "
                         "(see repro_torch.resilience.faults; also "
                         "REPRO_FAULTS)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the fault injector's corruption bits")
    ap.add_argument("--no-guard", action="store_true",
                    help="disable the non-finite step guard (also "
                         "REPRO_GUARD_STEP=0)")
    ap.add_argument("--ckpt-delta", action="store_true",
                    default=os.environ.get("REPRO_CKPT_DELTA", "").lower()
                    in ("1", "true", "on", "yes"),
                    help="incremental checkpoints: persist only the pool "
                         "chunks dirtied since the last base (also "
                         "REPRO_CKPT_DELTA=1)")
    ap.add_argument("--ckpt-compact-every", type=int, default=8,
                    help="delta-chain length before forcing a full base "
                         "checkpoint")
    ap.add_argument("--tier-budget-mb", type=float, default=None,
                    help="per-device memory budget for the embedding pool; "
                         "a pool that exceeds it trains through the tiered "
                         "store (HBM-hot / host-cold, repro_torch.tier) "
                         "bit-identically to the resident run (also "
                         "REPRO_TIER_BUDGET_MB)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.exchange is not None:
        # process-wide, as REPRO_DIST_EXCHANGE (the reference's launcher)
        from repro_torch.dist import exchange as exl
        exl.FORCED = None if args.exchange == "auto" else args.exchange
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_config(args.arch)
    kind_kw = {} if args.embedding_kind is None \
        else {"embedding_kind": args.embedding_kind}
    cfg = arch.make_smoke(**kind_kw) if (args.smoke or arch.family == "lm") \
        else arch.make_model(None, **kind_kw)
    tier_ctrl = None
    if arch.family == "recsys":
        gen, bufs, batch_fn, loss_fn = _recsys_setup(
            arch, cfg, args.n_signatures, args.batch, dev)
        model = recsys.init(cfg, device=dev)
        from repro_torch.tier import tier_budget_mb
        budget_mb = (args.tier_budget_mb if args.tier_budget_mb is not None
                     else tier_budget_mb())
        tiered_loss, tier_ctrl = _maybe_tier(cfg, arch, model, bufs,
                                             batch_fn, budget_mb)
        if tier_ctrl is not None:
            loss_fn = tiered_loss
        lps = lookups_per_step(cfg, args.batch)
        label = f"{args.arch} ({cfg.embedding.kind})"
    elif arch.family == "lm":
        from repro_torch.models import transformer
        from repro_torch.dist.context import current_mesh
        batch_fn, loss_fn = _lm_setup(cfg, args.batch)
        # under an installed mesh, this rank's lm_rules blocks
        model = transformer.init(cfg, device=dev, mesh=current_mesh(),
                                 train=True)
        lps = min(args.batch, 16) * 64
        label = args.arch
    else:
        raise SystemExit(f"use examples/ for family {arch.family}")
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    print(f"{label}: {n_params:,} parameters on {dev}")
    injector = None
    if args.faults:
        from repro_torch.resilience.faults import FaultInjector
        injector = FaultInjector(args.faults, seed=args.fault_seed)
        print(f"fault injection armed: {args.faults} (seed {args.fault_seed})")
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=100, log_every=max(args.steps // 10, 1),
                      lookups_per_step=lps,
                      ckpt_delta=args.ckpt_delta,
                      ckpt_compact_every=args.ckpt_compact_every,
                      guard_step=False if args.no_guard else None),
        # a tiered pool updates densely, as in the reference: its moments
        # mirror the compact pool, which the sparse optimizer's layout does
        # not
        loss_fn, model, make_optimizer(arch, sparse_ok=tier_ctrl is None),
        batch_fn, device=dev, faults=injector,
        sparse_grads=False if tier_ctrl is not None else None,
        tier=tier_ctrl)
    if trainer.sparse_grads:
        print("sparse memory-pool updates ON (REPRO_SPARSE_GRADS=0 for the "
              "dense oracle)")
    # the handlers are the run's: restored after it, since main() may run
    # inside a longer-lived process
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    trainer.install_signal_handlers()
    try:
        out = trainer.fit()
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    print(f"done: {out}")
    if trainer.health.any_faults():
        print(f"health: {trainer.health.summary()}")
    result = {"train": out, "health": trainer.health.as_dict()}
    eval_params = None
    if tier_ctrl is not None:
        # eval batches are unplanned: they go through the full pool
        eval_params = tier_ctrl.export_params(trainer.params)
        st = tier_ctrl.store
        result["tier"] = {**tier_ctrl.stats(),
                          "compact_slots": st.compact_slots,
                          "stage_blocks": st.stage_blocks,
                          "device_bytes": st.compact_bytes}
        print(f"tier: {result['tier']}")
    if arch.family == "recsys":
        met = evaluate(model, gen, bufs, args.eval_batches, dev, eval_params)
        print(f"eval: {met}")
        result["eval"] = met
    return result


if __name__ == "__main__":
    main()
