#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: serve full-width dlrm-rm2.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
sm_90 card and ``nvcc``; it imports only torch, numpy and ``repro_torch``
(from ``src/``), and it exits non-zero, printing no result, when there is
no card or no port beside it.

Phases (any failure raises and ends the run with a non-zero code):
  1. print the card's name and power limit; build the three CUDA kernels
     (one nvcc per source, in parallel);
  2. build dlrm-rm2 at full width on the card: the 135,053,312-slot striped
     LMA pool and the 33,762,577 x 32 D' store with planted clusters, a
     share of values made very sparse (support 0 or 1) so the fallback runs;
  3. hold each kernel against its plain PyTorch version on the card at the
     serving shapes (locations and lookups bit-exact, bag and dot within
     tolerance);
  4. serve single requests through the port's BatchingScorer (max_batch
     512) at two offered rates; the fused lookup and dot kernels must have
     launched; one served batch is recomputed from the plain versions;
  5. the split lookup (locations kernel + gather) over the served batch;
     the locations kernel must have launched;
  6. time each kernel at B=512 and B=4096 (device time from CUDA-graph
     replay) beside its bound, its plain version and, for the dot,
     torch.bmm; print one line per kernel, the ``kernels`` JSON line, the
     card line, and last the result line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# (offered requests per second, open loop; requests): full batches of 512,
# then a trickle where the 2 ms batching delay cuts small batches
SERVE_RUNS = ((100_000, 2048), (5_000, 1024))
TICK_S = 1e-3
SPARSE_PERIOD = 50              # value v % 50 == 0: support 0, == 1: support 1
N_CLUSTERS = 4096

# Peak rates of one H100 SXM (NVIDIA's published figures; 700 W): 3.35 TB/s
# of HBM, 67 TFLOP/s float32 outside the tensor cores.  NVIDIA publishes no
# int32 ALU rate; the ceiling no mix of int32 instructions can pass is the
# dispatch limit, 4 schedulers x 32 lanes per SM per clock (logic, shifts
# and min on the 64-lane INT pipe, IMAD on the FMA pipe), so 132 SMs x 128
# x 1.98 GHz = 33.5 T int32 operations/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = 132 * 128 * 1.98e9

# int32 operations per unit of work, counted from csrc/hash_core.cuh
OPS_HASH = 15          # hash_u32 (14) + the running min, per seed x element
OPS_CHAIN_STEP = 11    # fmix32 (8) + xor, multiply, add per chain step
OPS_FINISH = 11        # final fmix32 (8) + slot arithmetic (3) per column
OPS_FALLBACK = 32      # hash_pair (29) + slot arithmetic (3) per column


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Host-launched time per call: CUDA events around ``iters`` calls.
    Includes launch overhead wherever the host is slower than the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between CUDA events, so no host launch cost is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lma_work(torch, p, rows, support, fallback: bool):
    """(bytes, int32 ops) the lookup of these rows needs (see OPS_*)."""
    N, S = rows.shape
    valid = (rows != -1).sum(dim=1)
    lma = support >= p.min_support if fallback else torch.ones_like(support,
                                                                     dtype=bool)
    n_fb = int((~lma).sum())
    ops = (p.n_raw_hashes * OPS_HASH * int(valid[lma].sum())
           + (N - n_fb) * p.d * (p.n_h * OPS_CHAIN_STEP + OPS_FINISH)
           + n_fb * p.d * OPS_FALLBACK)
    nbytes = (N - n_fb) * S * 4 + N * p.d * 4          # sets in, d slots out
    if fallback:
        nbytes += N * 8 + N * p.d * 4     # ids + support in, gathered floats
    return nbytes, ops


# -------------------------------------------------------------- requests

def draw_requests(rng, vocabs, n: int, n_dense: int) -> dict:
    """Ids skewed toward each field's head (P(id < k) = (k/V)^(1/3)),
    dense features log-transformed counts, all from the seed."""
    v = np.asarray(vocabs)
    u = rng.random((n, len(vocabs)))
    sparse = np.minimum((u ** 3 * v).astype(np.int64), v - 1)
    dense = np.log1p(rng.exponential(4.0, (n, n_dense)))
    return {"sparse": sparse.astype(np.int32),
            "dense": dense.astype(np.float32)}


def global_ids(torch, cfg, batch, dev):
    """[B, F] field-local ids -> [B*F] ids in the common-memory space."""
    ids = torch.from_numpy(batch["sparse"]).to(dev)
    offs = torch.as_tensor(cfg.embedding.table_offsets()[:-1],
                           dtype=torch.int32, device=dev)
    return (ids + offs[None, :]).reshape(-1).contiguous()


# ------------------------------------------------------------------ phases

def build_model(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.core.signatures import planted_dense_store
    from repro_torch.models.recsys import Recsys

    cfg = get_config("dlrm-rm2").make_model()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Recsys(cfg, gen, device=dev).eval()
    store = planted_dense_store(cfg.embedding.total_vocab, N_CLUSTERS,
                                max_set=cfg.embedding.lma.max_set, seed=SEED,
                                device=dev)
    v = torch.arange(store.n_values, device=dev)
    zero, one = v % SPARSE_PERIOD == 0, v % SPARSE_PERIOD == 1
    store.sets[zero] = -1
    store.sets[one, 1:] = -1
    store.lengths[zero] = 0
    store.lengths[one] = 1
    bufs = cfg.table.make_buffers(store)
    torch.cuda.synchronize()
    p = cfg.embedding.lma
    log(f"model: dlrm-rm2, m={p.m} stripe={p.stripe} d={p.d} n_h={p.n_h} "
        f"max_set={p.max_set} min_support={p.min_support}; D' store "
        f"{tuple(store.sets.shape)} int32 "
        f"({store.sets.numel() * 4 / 1e9:.2f} GB); very sparse share "
        f"{2 / SPARSE_PERIOD:.1%} of values (support 0: 1/{SPARSE_PERIOD}, "
        f"support 1: 1/{SPARSE_PERIOD}); built in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, bufs


def kernel_inputs(torch, cfg, model, bufs, batch, dev):
    """Everything the three kernels see for one batch of requests."""
    gids = global_ids(torch, cfg, batch, dev)
    rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs, gids)
    with torch.inference_mode():
        feats = model.embedding["memory"][
            cfg.table.scheme.locations(cfg.embedding, bufs, gids).long()]
        bot = model.bot(torch.from_numpy(batch["dense"]).to(dev))
        allf = torch.cat([bot[:, None, :],
                          feats.reshape(-1, cfg.n_fields, cfg.embedding.dim)],
                         dim=1).contiguous()
    return gids, rows, support, allf


def check_kernels(torch, cfg, model, bufs, batch, dev) -> dict:
    from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
    from repro_torch.kernels.dot_interaction.ref import dot_interaction_ref
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.kernels.fused_embed.ref import (fused_embed_bag_ref,
                                                     fused_lookup_ref)
    from repro_torch.kernels.lma_locations.kernel import lma_locations_cuda
    from repro_torch.kernels.lma_locations.ref import lma_locations_ref

    p = cfg.embedding.lma
    mem = model.embedding["memory"].detach()
    gids, rows, support, allf = kernel_inputs(torch, cfg, model, bufs, batch,
                                              dev)
    n_fb = int((support < p.min_support).sum())
    if n_fb == 0:
        raise AssertionError("the check batch holds no fallback rows")
    err = {"lma_locations": 0.0}
    with torch.inference_mode():
        for params in (dataclasses.replace(p, striped=False), p):
            got = lma_locations_cuda(params, rows)
            want = lma_locations_ref(params, rows)
            err["lma_locations"] = max(err["lma_locations"], float(
                (got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"lma_locations differ (stripe "
                                     f"{params.stripe})")
            spec = fe.lma_spec(params)
            got = fused_lookup_cuda(spec, mem, gids, rows, support)
            want = fused_lookup_ref(spec, mem, gids, rows, support)
            if not torch.equal(got, want):
                raise AssertionError(f"fused lookup differs (stripe "
                                     f"{params.stripe})")
        B, F = batch["sparse"].shape
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        w = torch.rand((B, F), generator=gen, device=dev)
        shaped = (gids.reshape(B, F), w, rows.reshape(B, F, -1),
                  support.reshape(B, F))
        spec = fe.lma_spec(p)
        bag = fused_lookup_cuda(spec, mem, shaped[0], shaped[2], shaped[3],
                                shaped[1])
        bag_want = fused_embed_bag_ref(spec, mem, *shaped)
        torch.testing.assert_close(bag, bag_want, rtol=1e-6, atol=1e-6)
        err["fused_embed"] = float((bag - bag_want).abs().max())
        z = dot_interaction_cuda(allf)
        z_want = dot_interaction_ref(allf)
        torch.testing.assert_close(z, z_want, rtol=1e-5, atol=1e-6)
        err["dot_interaction"] = float((z - z_want).abs().max())
    log(f"check at B={B} ({gids.numel()} values, {n_fb} fallback rows): "
        "locations bit-exact flat and striped; lookups bit-exact flat and "
        f"striped; bag max |err| {err['fused_embed']:.3g} (tol 1e-6); dot "
        f"max |err| {err['dot_interaction']:.3g} (rtol 1e-5)")
    return err


def plain_forward(torch, cfg, model, bufs, batch, dev):
    """The DLRM forward through the plain versions only (split lookup,
    pairwise-product interaction)."""
    from repro_torch.embed import SPLIT
    from repro_torch.kernels.dot_interaction.ref import dot_interaction_ref

    gids = global_ids(torch, cfg, batch, dev)
    feats = SPLIT.lookup(cfg.embedding, cfg.table.scheme,
                         dict(model.embedding), bufs, gids)
    bot = model.bot(torch.from_numpy(batch["dense"]).to(dev))
    allf = torch.cat([bot[:, None, :],
                      feats.reshape(-1, cfg.n_fields, cfg.embedding.dim)],
                     dim=1)
    z = dot_interaction_ref(allf)
    return model.top(torch.cat([bot, z], dim=-1))[:, 0]


def serve(torch, cfg, model, bufs, dev, kernels) -> tuple:
    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE
    from repro_torch.serve import BatchingScorer, model_score_fn, pad_buckets

    max_batch = RECSYS_SHAPE_TABLE["serve_p99"]["batch"]
    score = model_score_fn(model, bufs)
    served = []

    def score_fn(batch):
        t0 = time.perf_counter()
        out = score(batch)            # returns host numpy: the call is synced
        served.append((batch, out, time.perf_counter() - t0))
        return out

    rng = np.random.default_rng(SEED + 3)
    warm = draw_requests(rng, cfg.embedding.vocab_sizes, max_batch,
                         cfg.n_dense)
    for b in pad_buckets(max_batch):    # first call of each bucket's shapes
        score_fn({k: v[:b] for k, v in warm.items()})
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in warm.items()}
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: model(on_card, bufs), 20)
    log(f"forward of a {max_batch}-request batch already on the card: "
        f"{fwd_ms:.3f} ms (host-launched)")
    for k in kernels.values():
        k.launches = 0
    served.clear()
    runs = []
    for rate, n in SERVE_RUNS:
        first = len(served)
        reqs = draw_requests(rng, cfg.embedding.vocab_sizes, n, cfg.n_dense)
        runs.append(drive(BatchingScorer(score_fn, max_batch=max_batch,
                                         max_delay_ms=2.0), reqs, rate))
        runs[-1]["device_call_ms"] = float(
            np.mean([s[2] for s in served[first:]]) * 1e3)
        log("served {requests} requests at an offered {rate} requests/s in "
            "{device_calls} device calls (mean batch {mean_batch:.1f}, max "
            "{max_batch}; {device_call_ms:.3f} ms per call); latency ms "
            "p50={p50:.3f} p99={p99:.3f}".format(**runs[-1]))
    counts = {name: k.launches for name, k in kernels.items()}
    runs.append({"forward_ms_b512": fwd_ms})
    log(f"launches while serving: {counts}")
    for name in ("fused_embed", "dot_interaction"):
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched while serving")
    # the largest batch served, against the plain versions
    batch, out, _ = max(served, key=lambda s: len(s[1]))
    with torch.inference_mode():
        want = plain_forward(torch, cfg, model, bufs, batch, dev).cpu().numpy()
    if out.shape != want.shape or not np.isfinite(out).all():
        raise AssertionError("served logits have the wrong shape")
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    log(f"served batch of {len(out)} vs plain versions: max |err| "
        f"{float(np.abs(out - want).max()):.3g} (tol 1e-4)")
    return counts, runs, batch


def drive(scorer, reqs: dict, rate: float) -> dict:
    """Submit single requests open loop at ``rate`` per second, wait for
    every result; -> batching and latency statistics."""
    n = len(reqs["sparse"])
    pending = []
    try:
        t0 = time.perf_counter()
        while len(pending) < n:
            # every 1 ms tick, submit what is due, then sleep: a client
            # that spun between arrivals would hold the GIL and starve the
            # scorer's worker thread
            due = min(n, int((time.perf_counter() - t0) * rate) + 1)
            for i in range(len(pending), due):
                pending.append(scorer.submit({k: v[i]
                                              for k, v in reqs.items()}))
            time.sleep(TICK_S)
        for p in pending:
            if not p.event.wait(60.0):
                raise TimeoutError("a request was not served")
            if p.error is not None:
                raise p.error
    finally:
        scorer.close()
    scores = np.asarray([p.result for p in pending])
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite logits")
    lat = np.asarray([p.t_done - p.t_enqueue for p in pending]) * 1e3
    return {"rate": rate, "requests": scorer.n_requests,
            "device_calls": scorer.n_batches,
            "mean_batch": float(np.mean(scorer.batch_sizes)),
            "max_batch": int(np.max(scorer.batch_sizes)),
            "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)), "max_ms": float(lat.max())}


def split_lookup(torch, cfg, model, bufs, batch, dev, kernels) -> int:
    """The split lookup path over a served batch: the locations kernel,
    then a gather; equal to the fused lookup on every non-fallback row."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.lma_locations.ops import lma_gather

    p = cfg.embedding.lma
    mem = model.embedding["memory"].detach()
    gids = global_ids(torch, cfg, batch, dev)
    rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs, gids)
    for k in kernels.values():
        k.launches = 0
    with torch.inference_mode():
        split = lma_gather(p, mem, rows)
        n = kernels["lma_locations"].launches
        fused = fe.fused_lookup(fe.lma_spec(p), mem, gids, rows, support)
    if n == 0:
        raise AssertionError("lma_locations was not launched")
    dense = support >= p.min_support
    if not torch.equal(split[dense], fused[dense]):
        raise AssertionError("split and fused lookups differ")
    log(f"split lookup over {gids.numel()} served values: launches "
        f"lma_locations={n}; equal to the fused lookup on "
        f"{int(dense.sum())} non-fallback rows")
    return n


def measure(torch, cfg, model, bufs, dev) -> dict:
    from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
    from repro_torch.kernels.dot_interaction.ref import (dot_interaction_ref,
                                                         tril_pairs)
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.kernels.fused_embed.ref import fused_lookup_ref
    from repro_torch.kernels.lma_locations.kernel import lma_locations_cuda
    from repro_torch.kernels.lma_locations.ref import lma_locations_ref

    p = cfg.embedding.lma
    spec = fe.lma_spec(p)
    mem = model.embedding["memory"].detach()
    res = {"lma_locations": {}, "fused_embed": {}, "dot_interaction": {}}
    rng = np.random.default_rng(SEED + 4)
    for B in (512, 4096):
        batch = draw_requests(rng, cfg.embedding.vocab_sizes, B, cfg.n_dense)
        gids, rows, support, allf = kernel_inputs(torch, cfg, model, bufs,
                                                  batch, dev)
        iters = 50 if B == 512 else 10
        with torch.inference_mode():
            r = res["lma_locations"][B] = {}
            r["ms"] = graph_ms(torch, lambda: lma_locations_cuda(p, rows),
                               iters)
            r["plain_ms"] = time_ms(torch, lambda: lma_locations_ref(p, rows),
                                    2, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(
                *lma_work(torch, p, rows, support, fallback=False),
                INT32_OP_PER_S)
            r["library_ms"] = None

            r = res["fused_embed"][B] = {}
            r["ms"] = graph_ms(torch, lambda: fused_lookup_cuda(
                spec, mem, gids, rows, support), iters)
            r["plain_ms"] = time_ms(torch, lambda: fused_lookup_ref(
                spec, mem, gids, rows, support), 2, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(
                *lma_work(torch, p, rows, support, fallback=True),
                INT32_OP_PER_S)
            r["library_ms"] = None

            r = res["dot_interaction"][B] = {}
            Bx, F, d = allf.shape
            P = F * (F - 1) // 2
            ii, jj = tril_pairs(F, dev)
            r["ms"] = graph_ms(torch, lambda: dot_interaction_cuda(allf),
                               iters * 10)
            r["plain_ms"] = time_ms(torch, lambda: dot_interaction_ref(allf),
                                    iters)
            r["library_ms"] = graph_ms(torch, lambda: torch.bmm(
                allf, allf.transpose(1, 2))[:, ii, jj], iters * 10)
            r["bound_ms"], r["bound_by"] = bound(
                (Bx * F * d + Bx * P) * 4, 2 * Bx * P * d, FP32_FLOP_PER_S)
        for name in res:
            r = res[name][B]
            log(f"  {name} B={B}: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms']:.1%} of bound"
                + (f", library {r['library_ms']:.4f} ms"
                   if r["library_ms"] is not None else ""))
    return res


# -------------------------------------------------------------------- main

SOURCES = {
    "lma_locations": ("src/repro_torch/csrc/lma_locations.cu",
                      "src/repro/kernels/lma_locations/kernel.py:108"),
    "fused_embed": ("src/repro_torch/csrc/fused_embed.cu",
                    "src/repro/kernels/fused_embed/kernel.py:356"),
    "dot_interaction": ("src/repro_torch/csrc/dot_interaction.cu",
                        "src/repro/kernels/dot_interaction/kernel.py:48"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import KERNELS, build
    from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.kernels.lma_locations.kernel import lma_locations_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    t0 = time.perf_counter()
    reports = build.build_all(list(KERNELS))
    log(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "Used" in ln]
        log(f"  {name}: {'; '.join(regs)}")
    kernels = {"lma_locations": lma_locations_cuda,
               "fused_embed": fused_lookup_cuda,
               "dot_interaction": dot_interaction_cuda}

    cfg, model, bufs = build_model(torch, dev)
    rng = np.random.default_rng(SEED)
    check_batch = draw_requests(rng, cfg.embedding.vocab_sizes, 512,
                                cfg.n_dense)
    err = check_kernels(torch, cfg, model, bufs, check_batch, dev)
    counts, runs, served = serve(torch, cfg, model, bufs, dev, kernels)
    counts["lma_locations"] = split_lookup(torch, cfg, model, bufs, served,
                                           dev, kernels)
    res = measure(torch, cfg, model, bufs, dev)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")

    rows = []
    for name, (source, replaces) in SOURCES.items():
        at512, at4096 = res[name][512], res[name][4096]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": err[name], "ms": at512["ms"],
            "plain_ms": at512["plain_ms"], "bound_ms": at512["bound_ms"],
            "bound_by": at512["bound_by"],
            "library_ms": at512["library_ms"],
            "batch": 512, "at_batch_4096": at4096,
        })
        log(f"kernel {name}: launches {counts[name]}, max |err| "
            f"{err[name]:.3g}; B=512 {at512['ms']:.4f} ms (bound "
            f"{at512['bound_ms']:.4f} ms, {at512['bound_by']}); B=4096 "
            f"{at4096['ms']:.4f} ms (bound {at4096['bound_ms']:.4f} ms, "
            f"{at4096['bound_by']}); card {card}")
    log(json.dumps({"serving": runs, "card": card}))
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
