"""Cases and rank functions of the LM-under-a-mesh tests
(``test_torch_flash_decode.py``, ``test_torch_lm_mesh.py``,
``test_torch_lm_mesh_model.py``, the CUDA IPC gather's card test).

Not a test module and it imports no JAX: ``lm_mesh_reference.py`` (the
reference, in a process of its own with four forced host devices) and the
port's gloo ranks both build every case here from numpy and a seed, so
they see the same arrays.
"""
from __future__ import annotations

import numpy as np
import torch

MESHES = ((1, 4), (2, 2), (4, 1))
DP_AXES = ("data",)

# ------------------------------------------------------------ flash decode

FD_H, FD_KV, FD_HD, FD_R = 4, 2, 8, 6


def fd_cases() -> list[dict]:
    """float and int8 caches; B = 4 and 1 (the length over the whole
    mesh); a mid-cache write, ``cache_len = L`` (the clamp), an L that
    only 'model' divides at (2, 2) and one that nothing divides (the
    fallback); MLA's form (V the first columns of K, one scale)."""
    out = []
    for quant in (False, True):
        for B in (4, 1):
            for L, pos in ((16, 5), (16, 16), (18, 7), (17, 9)):
                out.append(dict(quant=quant, B=B, L=L, pos=pos, mla=False))
        out.append(dict(quant=quant, B=4, L=16, pos=11, mla=True))
    return out


def _quant(x):
    s = np.maximum(np.abs(x).max(-1), 1e-8) / 127.0
    q = np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def fd_inputs(case: dict, i: int) -> dict:
    """numpy inputs of flash-decode case ``i``: q [B, 1, H, hd], the
    cache [B, L, KV, hd] (MLA: one head of width hd, V its first R
    columns), the new entries; int8 with scales."""
    rng = np.random.default_rng(100 + i)
    B, L = case["B"], case["L"]
    KV = 1 if case["mla"] else FD_KV
    H = FD_H
    f32 = np.float32
    q = rng.normal(size=(B, 1, H, FD_HD)).astype(f32)
    k = rng.normal(size=(B, L, KV, FD_HD)).astype(f32)
    kn = rng.normal(size=(B, 1, KV, FD_HD)).astype(f32)
    if case["mla"]:
        v, vn = k[..., :FD_R], kn[..., :FD_R]
    else:
        v = rng.normal(size=(B, L, KV, FD_HD)).astype(f32)
        vn = rng.normal(size=(B, 1, KV, FD_HD)).astype(f32)
    out = dict(q=q, k=k, v=v, kn=kn, vn=vn)
    if case["quant"]:
        (out["k"], out["ks"]), (out["kn"], out["ksn"]) = _quant(k), _quant(kn)
        if case["mla"]:
            out["v"], out["vs"] = out["k"][..., :FD_R], out["ks"]
            out["vn"], out["vsn"] = out["kn"][..., :FD_R], out["ksn"]
        else:
            (out["v"], out["vs"]), (out["vn"], out["vsn"]) = (_quant(v),
                                                              _quant(vn))
    return out


def flash_rank(mesh, cases: list) -> list:
    """Each case through the port's ``sharded_flash_decode`` on this
    rank's slab -> [{"o", the slab's "k" (and "v", "ks", "vs"), "rows",
    "pos"}]."""
    from repro_torch.dist import flash_decode as fd
    from repro_torch.dist.flash_decode import cache_split, \
        sharded_flash_decode

    fd.BLOCK_BYTES = 0          # blocks of 4 positions: the merge in a slab
    out = []
    for i, case in enumerate(cases):
        a = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in fd_inputs(case, i).items()}
        B, L = case["B"], case["L"]
        (b0, b1), (lo, hi) = cache_split(mesh, DP_AXES, B, L)
        k = a["k"][b0:b1, lo:hi].clone()
        v = k[..., :FD_R] if case["mla"] else a["v"][b0:b1, lo:hi].clone()
        kw = {}
        if case["quant"]:
            ks = a["ks"][b0:b1, lo:hi].clone()
            vs = ks if case["mla"] else a["vs"][b0:b1, lo:hi].clone()
            kw = dict(k_scale=ks, v_scale=vs, k_scale_new=a["ksn"],
                      v_scale_new=a["vsn"])
        o = sharded_flash_decode(
            a["q"], k, v, a["kn"], a["vn"], case["pos"],
            sm_scale=1.0 / np.sqrt(FD_HD), mesh=mesh, dp_axes=DP_AXES,
            length=L, block=4, **kw)
        r = {"o": o.numpy(), "k": k.numpy(), "rows": (b0, b1),
             "pos": (lo, hi)}
        if not case["mla"]:
            r["v"] = v.numpy()
        if case["quant"]:
            r["ks"] = kw["k_scale"].numpy()
            if not case["mla"]:
                r["vs"] = kw["v_scale"].numpy()
        out.append(r)
    return out


# ------------------------------------------------------------ the MoE

MOE_D, MOE_F, MOE_K = 16, 24, 2


def moe_cases(mesh: tuple) -> list[dict]:
    """(router, E, T, full_token_sharding, lead, capacity factor): the
    token ladder's three rungs, ``lead`` off dp_size, capacities that drop
    (T = 128 at factor 0.5), and E = 6, which EP cannot take (experts over
    'model', d stored over 'data'; at (1, 4) 'model' does not divide it and
    the reference computes only E // M of them, so it is left out)."""
    D = mesh[0]
    cases = [("softmax", 8, 16, False, None, 1.25),
             ("softmax", 8, 16, True, D, 1.25),
             ("sigmoid", 8, 16, True, None, 1.25),
             ("sigmoid", 8, 16, True, D + 1, 1.25),
             ("softmax", 8, 5, True, D, 1.25),
             ("sigmoid", 8, 128, False, None, 0.5),
             ("softmax", 8, 128, True, D, 0.5)]
    if mesh != (1, 4):
        cases.append(("softmax", 6, 16, False, None, 1.25))
    return [dict(router=r, E=E, T=T, full=full, lead=lead, cf=cf)
            for r, E, T, full, lead, cf in cases]


def moe_config(case: dict):
    from repro_torch.nn.moe import MoEConfig
    return MoEConfig(MOE_D, MOE_F, case["E"], MOE_K, n_shared_experts=1,
                     router=case["router"], capacity_factor=case["cf"])


def moe_inputs(case: dict, i: int) -> dict:
    """numpy parameters in the reference's layout (kernels [in, out]) and
    x [T, d]."""
    rng = np.random.default_rng(300 + i)
    E, d, f = case["E"], MOE_D, MOE_F
    f32 = np.float32

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(f32)
    return {"router": n(d, E, s=d ** -0.5),
            "w_gate": n(E, d, f, s=d ** -0.5),
            "w_up": n(E, d, f, s=d ** -0.5),
            "w_down": n(E, f, d, s=f ** -0.5),
            "shared_gate": n(d, f, s=d ** -0.5),
            "shared_up": n(d, f, s=d ** -0.5),
            "shared_down": n(f, d, s=f ** -0.5),
            "x": n(case["T"], d)}


def moe_module(cfg, a: dict, mesh):
    """The port's MoE holding the reference's parameters: with a mesh,
    built with it (its storage blocks) and loaded block by block."""
    from repro_torch.dist.sharding import block
    from repro_torch.nn import moe as tmoe

    gen = torch.Generator().manual_seed(0)
    mod = tmoe.moe_init(cfg, gen, "cpu", mesh=mesh)
    sg, sd = tmoe._moe_w_specs(cfg, mesh)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    with torch.no_grad():
        mod.router.weight.copy_(t["router"].T)
        for name, spec in (("w_gate", sg), ("w_up", sg), ("w_down", sd)):
            getattr(mod, name).copy_(block(t[name], mesh, spec)
                                     if mesh is not None else t[name])
        for name in ("gate", "up", "down"):
            getattr(mod.shared, name).weight.copy_(t[f"shared_{name}"].T)
    return mod


def moe_rank(mesh, mesh_shape: tuple) -> list:
    """Each case of ``moe_cases(mesh_shape)`` through the port's
    ``moe_apply_sharded`` -> [{"out", "aux", "C", "dropped",
    "stored"}]."""
    from repro_torch.nn import moe as tmoe

    out = []
    for i, case in enumerate(moe_cases(mesh_shape)):
        cfg = moe_config(case)
        a = moe_inputs(case, i)
        mod = moe_module(cfg, a, mesh)
        stats = {}
        with torch.no_grad():
            y, aux = tmoe.moe_apply_sharded(
                mod, cfg, torch.from_numpy(a["x"]), mesh, DP_AXES,
                full_token_sharding=case["full"], lead=case["lead"],
                stats=stats)
        ids = stats["ids"]
        out.append({"out": y.numpy(), "aux": float(aux), "C": stats["C"],
                    "dropped": int(tmoe.dropped(stats["load"][ids],
                                                stats["C"])),
                    "stored": tuple(mod.w_gate.shape)})
    return out


# ------------------------------------------------------------ the whole LM

LM_ARCHS = ("tinyllama-1.1b", "deepseek-v3-671b", "llama4-scout-17b-a16e")
LM_B, LM_S, LM_L, LM_STEPS = 4, 6, 16, 3
# two waves whose decode capacity (prompt + new tokens) 4 divides, so the
# served caches shard
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 3, 32, 7


def lm_config(arch: str, quant: bool, embedding=None):
    """The port's smoke config of ``arch`` at the drop-free capacity
    factor (E / k x 1.05), an int8 cache when ``quant``."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).make_smoke()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k
            * 1.05))
    if quant:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if embedding is not None:
        cfg = dataclasses.replace(cfg, embedding=embedding)
    return cfg


def lm_tokens(vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"prompt": rng.integers(0, vocab, (LM_B, LM_S)).astype(np.int32),
            "steps": rng.integers(0, vocab, (LM_STEPS, LM_B)).astype(
                np.int32),
            "serve": [list(map(int, rng.integers(1, vocab, n)))
                      for n in (3, 9, 5, 5, 2)]}


def _host_cache(cache: dict) -> dict:
    return {g: {k: v.clone().numpy() for k, v in c.items()}
            for g, c in cache.items()}


def lm_run(cfg, np_params: dict, toks: dict, mesh=None) -> dict:
    """Prefill the prompt into a cache of ``LM_L`` rows, then ``LM_STEPS``
    decode steps fed ``toks["steps"]``; then the ``LMServer`` over
    ``toks["serve"]``.  With a mesh (installed here), this rank's share
    and slab.  -> {"logits": [prefill, steps...], "caches": the cache
    after each, "slab": ((b0, b1), (lo, hi)), "served": tokens, "aux"}."""
    import contextlib

    from repro_torch.convert import lm_params_from_jax
    from repro_torch.dist.context import use_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.serve.lm import LMServer

    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        model = tt.init(cfg, seed=1, device="cpu", mesh=mesh)
        model.load_state_dict(lm_params_from_jax(np_params, cfg, "cpu",
                                                 mesh))
        model.eval()
        cache = tt.init_cache(cfg, LM_B, LM_L, "cpu")
        logits, cache = tt.prefill(model, cfg, torch.from_numpy(
            toks["prompt"]), cache=cache, length=LM_L)
        out = {"logits": [logits.numpy()], "caches": [_host_cache(cache)],
               "slab": tt.cache_slab(LM_B, LM_L)}
        for t in range(LM_STEPS):
            logits, cache = tt.decode_step(
                model, cfg, torch.from_numpy(toks["steps"][t]), cache,
                LM_S + t, length=LM_L)
            out["logits"].append(logits.numpy())
            out["caches"].append(_host_cache(cache))
        server = LMServer(model, cfg, n_slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN)
        out["served"] = [r.tokens for r in server.generate(
            toks["serve"], max_new_tokens=SERVE_NEW)]
    return out


def lm_rank(mesh, runs: list) -> list:
    """``lm_run`` of each (arch, quant, np_params, toks) on this rank."""
    return [lm_run(lm_config(arch, quant), p, toks, mesh)
            for arch, quant, p, toks in runs]


# ------------------------------------------------------------ the LMA table

def lma_rank(mesh, cfg, np_pool, np_store: dict, tokens) -> dict:
    """``embed_tokens`` of ``tokens`` [B, S] under each pinned strategy
    through the port's LMA token table (this rank's pool slab and store
    rows) -> {strategy: (out, the strategy that ran)}."""
    from repro_torch.convert import buffers_from_numpy
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import row_slab
    from repro_torch.embed import get_scheme
    from repro_torch.models import transformer as tt

    out = {}
    with use_mesh(mesh), torch.no_grad():
        model = tt.init(cfg, seed=1, device="cpu", mesh=mesh)
        model.embed["memory"].copy_(row_slab(torch.from_numpy(np_pool),
                                             mesh))
        bufs = buffers_from_numpy(np_store, "cpu", mesh)
        tok = torch.from_numpy(tokens)
        for strategy in ("psum", "ring", "all_to_all"):
            prev, exl.FORCED = exl.FORCED, strategy
            try:
                got = tt.embed_tokens(model, cfg, tok, bufs)
                ran = get_scheme("lma").sharded_lookup(
                    cfg.embedding, dict(model.embed), bufs,
                    tok.reshape(-1), mesh).strategy
            finally:
                exl.FORCED = prev
            out[strategy] = (got.numpy(), ran)
    return out


# ------------------------------------------------------------ small pieces

def decode_pieces(mesh, seed: int = 0) -> dict:
    """GQA's and MLA's decode (float caches of 4 rows, B = 1, the length
    over 'model') and the MoE dispatch on modules drawn from ``seed``, under
    ``mesh`` (installed here) or none -> outputs and caches as numpy."""
    import contextlib

    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.flash_decode import cache_split
    from repro_torch.nn import attention as ta
    from repro_torch.nn import moe as tmoe

    gen = torch.Generator().manual_seed(seed)
    gcfg = ta.GQAConfig(64, 8, 2)
    gqa = ta.gqa_init(gcfg, gen, "cpu")
    mcfg = ta.MLAConfig(64, 4, 32, 16, 16, 8, 16)
    mla = ta.mla_init(mcfg, gen, "cpu")
    ecfg = tmoe.MoEConfig(64, 32, 4, 1, 1)
    experts = tmoe.moe_init(ecfg, gen, "cpu")
    x = torch.randn((1, 1, 64), generator=gen)
    k = torch.randn((1, 4, 2, 8), generator=gen)
    v = torch.randn((1, 4, 2, 8), generator=gen)
    ckv = torch.randn((1, 4, 24), generator=gen)
    xm = torch.randn((4, 64), generator=gen)
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx, torch.no_grad():
        (_, _), (lo, hi) = cache_split(mesh, DP_AXES, 1, 4) \
            if mesh is not None else ((0, 1), (0, 4))
        cache = {"k": k[:, lo:hi].clone(), "v": v[:, lo:hi].clone()}
        g, _ = ta.gqa_decode(gqa, gcfg, x, cache, 2, length=4)
        lat = {"ckv": ckv[:, lo:hi].clone()}
        m, _ = ta.mla_decode(mla, mcfg, x, lat, 3, length=4)
        e, aux = tmoe.moe_dispatch(experts, ecfg, xm)
    return {"gqa": g.numpy(), "mla": m.numpy(), "moe": e.numpy(),
            "aux": float(aux), "k": cache["k"].numpy(),
            "ckv": lat["ckv"].numpy(), "pos": (lo, hi)}


def moe_dispatch_rank(mesh, cfg, state: dict, x) -> tuple:
    """``moe_dispatch`` under ``mesh`` of a MoE holding ``state`` (numpy,
    whole stacks) on x (numpy) -> (out, aux)."""
    from repro_torch.dist.context import use_mesh
    from repro_torch.nn import moe as tmoe

    mod = tmoe.moe_init(cfg, torch.Generator().manual_seed(0), "cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with use_mesh(mesh), torch.no_grad():
        out, aux = tmoe.moe_dispatch(mod, cfg, torch.from_numpy(x))
    return out.numpy(), float(aux)


def gather_paths_rank(mesh) -> dict:
    """Each axis's ``all_gather`` of CUDA tensors through CUDA IPC (the
    ranks share one card) and staged through the host -> whether the two
    are bit-equal, by case, and the IPC calls made."""
    from repro_torch.dist import collectives as col

    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for n in (7, 3 << 20):               # under and over IPC_MIN_BYTES
            x = (torch.arange(n, device=mesh.device) * 3 + mesh.world_rank
                 ).to(dtype)
            for axis in ("model", "data", "world"):
                mesh.one_card = True
                ipc = col.all_gather(x, mesh, axis)
                mesh.one_card = False
                staged = col.all_gather(x, mesh, axis)
                out[(str(dtype), n, axis)] = bool(torch.equal(ipc, staged))
    out["ipc_calls"] = dict(mesh.ipc_calls)
    return out


def collectives_rank(mesh) -> dict:
    """``psum`` over an axis or axis set, ``psum_scatter`` over 'model',
    on this rank's x = arange(8) + 10 * world rank."""
    from repro_torch.dist import collectives as col

    x = torch.arange(8, dtype=torch.float32) + 10 * mesh.world_rank
    return {"psum": {a: col.psum(x, mesh, a).numpy()
                     for a in (("model",), "data", ("data", "model"))},
            "scatter": col.psum_scatter(x, mesh).numpy()}


# ------------------------------------------------------------ training

TRAIN_LMA = "tinyllama-1.1b+lma"
TRAIN_CASES = ("tinyllama-1.1b", "deepseek-v3-671b", "llama4-scout-17b-a16e",
               TRAIN_LMA, TRAIN_LMA + ":dense")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 3
TRAIN_MESHES = ((1, 4), (2, 2))


def train_config(name: str):
    """The port's smoke config of case ``name`` (an arch, with ``+lma`` an
    LMA token table; ``:dense`` the dense pool gradient) at the drop-free
    capacity factor, remat on and the loss in two chunks."""
    import dataclasses

    from repro_torch.configs._recsys_common import embedding_of_kind
    arch = name.split("+")[0]
    emb = None
    if "+lma" in name:
        from repro_torch.configs import get_config
        c = get_config(arch).make_smoke()
        emb = embedding_of_kind("lma", (c.vocab_size,), c.d_model,
                                expansion=16.0, max_set=32)
    cfg = lm_config(arch, False, emb)
    return dataclasses.replace(cfg, remat=True, loss_chunk=TRAIN_S // 2)


def train_batches(vocab: int, seed: int) -> dict:
    """TRAIN_STEPS global batches of [TRAIN_B, TRAIN_S] tokens and labels."""
    rng = np.random.default_rng(seed)
    shape = (TRAIN_STEPS, TRAIN_B, TRAIN_S)
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": rng.integers(0, vocab, shape).astype(np.int32)}


def _host(x) -> np.ndarray:
    return x.detach().to(torch.float32).cpu().numpy().copy()


def _recording(opt, store: dict):
    """``opt`` whose first update records the gradients it is given (the
    step's, after the fold over 'data'), as numpy: a SparseGrad densified
    (its stream is the global batch's, over the whole pool) and cut to
    the parameter's block."""
    from repro_torch.dist.sharding import block, stored_mesh, stored_spec
    from repro_torch.optim import sparse as sp
    from repro_torch.optim.optimizers import Optimizer

    def dense(k, v, p):
        if not sp.is_sparse(v):
            return _host(v)
        d = v.densify().reshape(-1)
        if d.numel() != p.numel():
            d = block(d, stored_mesh(p), stored_spec(p))
        return _host(d.reshape(p.shape))

    def update(g, s, p=None):
        if not store:
            store.update({k: dense(k, v, p[k]) for k, v in g.items()})
        return opt.update(g, s, p)
    return Optimizer(opt.init, update)


def _state_blocks(state) -> dict:
    """An optimizer state's tensors by their path ('/'-joined), numpy."""
    from repro_torch.checkpoint.manager import _flatten
    return {k: _host(v) for k, v in _flatten(state).items()
            if isinstance(v, torch.Tensor)}


def train_run(name: str, np_params: dict, batches: dict, mesh=None,
              np_store: dict | None = None) -> dict:
    """TRAIN_STEPS steps of case ``name`` through the port's Trainer and
    the launcher's optimizer from ``np_params`` (the reference's tree,
    numpy), on this rank's ``lm_rules`` blocks under ``mesh`` (installed
    here) -> {"losses", "grads" (step 1), "params" (after), "opt" (the
    optimizer state's tensors), "specs"}: blocks as numpy."""
    import contextlib

    from repro_torch.configs import get_config
    from repro_torch.convert import buffers_from_numpy, lm_params_from_jax
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import stored_spec
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import transformer as tt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = train_config(name)
    arch = get_config(name.split("+")[0])
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    grads: dict = {}
    with ctx:
        model = tt.init(cfg, seed=1, device="cpu", mesh=mesh, train=True)
        model.load_state_dict(lm_params_from_jax(np_params, cfg, "cpu", mesh,
                                                 train=True))
        bufs = (buffers_from_numpy(np_store, "cpu", mesh)
                if np_store is not None else None)

        def loss(m, b):
            return tt.loss_fn(m, cfg, b["tokens"], b["labels"], bufs)
        tr = Trainer(TrainerConfig(total_steps=0, log_every=0), loss, model,
                     _recording(make_optimizer(arch), grads),
                     lambda step: {k: v[step] for k, v in batches.items()},
                     sparse_grads=("+lma" in name
                                   and not name.endswith(":dense")),
                     device="cpu")
        losses = []
        for s in range(1, TRAIN_STEPS + 1):
            tr.cfg.total_steps = s
            losses.append(tr.fit(log=lambda _: None)["loss"])
        params = {k: _host(p) for k, p in tr.params.items()}
        specs = {k: stored_spec(p) for k, p in tr.params.items()}
        return {"losses": losses, "grads": grads, "params": params,
                "opt": _state_blocks(tr.opt_state), "specs": specs,
                "sparse": tr.sparse_grads}


def collective_pieces(mesh) -> dict:
    """Each gradient-carrying collective on float64 x [4, 8] (this rank's,
    from a seed and its world rank) over each axis and dim: the forward,
    and the backward of a seeded cotangent beside the forward of its
    transpose on that cotangent."""
    from repro_torch.dist import collectives as col

    out = {}
    for axis in ("model", "data", ("data", "model")):
        n = col._axis(mesh, axis)[0]
        for dim in (0, 1):
            rng = np.random.default_rng(1000 + 7 * dim + mesh.world_rank)
            x = torch.from_numpy(rng.normal(size=(4, 8)))
            big = (4 * n, 8) if dim == 0 else (4, 8 * n)
            small = (4 // n, 8) if dim == 0 else (4, 8 // n)
            ct_g = torch.from_numpy(rng.normal(size=big))
            ct_s = torch.from_numpy(rng.normal(size=small))
            xg = x.clone().requires_grad_(True)
            y = col.gather_t(xg, mesh, axis, dim)
            y.backward(ct_g)
            xs = x.clone().requires_grad_(True)
            sc = col.scatter_t(xs, mesh, axis, dim)
            sc.backward(ct_s)
            out[(str(axis), dim)] = {
                "x": x.numpy(), "gather": y.detach().numpy(),
                "gather_ct": ct_g.numpy(), "gather_bwd": xg.grad.numpy(),
                "scatter_of_ct": col.scatter_t(ct_g, mesh, axis,
                                               dim).numpy(),
                "scatter": sc.detach().numpy(), "scatter_ct": ct_s.numpy(),
                "scatter_bwd": xs.grad.numpy(),
                "gather_of_ct": col.gather_t(ct_s, mesh, axis,
                                             dim).numpy()}
    rng = np.random.default_rng(2000 + mesh.world_rank)
    x = torch.from_numpy(rng.normal(size=(3, 5)))
    ct = torch.from_numpy(rng.normal(size=(3, 5)))
    xe = x.clone().requires_grad_(True)
    col.enter_model(xe, mesh).backward(ct)
    xl = x.clone().requires_grad_(True)
    y = col.leave_model(xl, mesh)
    y.backward(ct)
    out["model"] = {"x": x.numpy(), "ct": ct.numpy(),
                    "enter_bwd": xe.grad.numpy(),
                    "leave": y.detach().numpy(),
                    "leave_of_ct": col.leave_model(ct, mesh).numpy(),
                    "leave_bwd": xl.grad.numpy()}
    return out


ADAFACTOR_LEAVES = {"layers_0.0.ffn.gate.weight": (256, 128),
                    "layers_0.1.ffn.gate.weight": (256, 128),
                    "layers_0.0.ffn.down.weight": (128, 256),
                    "layers_0.0.moe.w_gate": (4, 128, 192),
                    "layers_0.0.attn.wq.weight": (64, 64),
                    "layers_0.0.norm_attn.scale": (128,),
                    "embed.table_0": (256, 128)}


def adafactor_leaves(seed: int) -> tuple:
    """Whole float32 parameters and two steps' gradients of
    ``ADAFACTOR_LEAVES`` (factored and not, transposed, a stacked expert
    leaf, a clip unit of two layers) from ``seed``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params = {k: rng.normal(size=s).astype(f32)
              for k, s in ADAFACTOR_LEAVES.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-3, 1)).astype(f32)
              for k, s in ADAFACTOR_LEAVES.items()} for _ in range(2)]
    return params, grads


def optimizer_blocks(mesh, seed: int) -> dict:
    """Two steps of ``adafactor`` and of ``chain(clip_by_global_norm,
    adam)`` on this rank's ``lm_spec`` blocks of ``adafactor_leaves`` ->
    the updates (blocks) and the adafactor state's tensors."""
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import StoredBlock, block, lm_spec
    from repro_torch.optim import optimizers as ol

    params, grads = adafactor_leaves(seed)
    out = {}
    with use_mesh(mesh):
        for kind, opt in (("adafactor", ol.adafactor(1e-2)),
                          ("clip_adam", ol.chain(ol.clip_by_global_norm(0.5),
                                                 ol.adam(1e-2)))):
            ps = {}
            for k, v in params.items():
                spec = lm_spec(k, v.shape, mesh)
                ps[k] = StoredBlock(torch.from_numpy(np.ascontiguousarray(
                    block(v, mesh, spec))), spec, mesh)
            st = opt.init(ps)
            ups = []
            for g in grads:
                gb = {k: torch.from_numpy(np.ascontiguousarray(
                    block(v, mesh, ps[k].spec))) for k, v in g.items()}
                u, st = opt.update(gb, st, ps)
                ups.append({k: _host(x) for k, x in u.items()})
            out[kind] = {"updates": ups, "state": _state_blocks(st),
                         "specs": {k: p.spec for k, p in ps.items()}}
    return out


def data_reduce_pieces(mesh) -> dict:
    """``guard._data_reduce`` over a block stored over 'data' and a leaf
    replicated over it: x = arange + 100 * world rank."""
    from repro_torch.dist.sharding import StoredBlock
    from repro_torch.resilience.guard import _data_reduce

    params = {"zero3": StoredBlock(torch.zeros(4), ("data",), mesh),
              "replicated": StoredBlock(torch.zeros(4), (None,), mesh)}
    g = {k: torch.arange(4, dtype=torch.float32) + 100 * mesh.world_rank
         for k in params}
    out, loss = _data_reduce(g, torch.tensor(1.0 + mesh.data_rank), mesh,
                             params)
    return {k: v.numpy() for k, v in out.items()} | {"loss": float(loss)}


def launch_rank(mesh, argv: list, ckpt: str) -> dict:
    """The launcher's 2 steps of an LM arch under ``mesh``; at (2, 2) it
    checkpoints into ``ckpt`` -> the Trainer's result."""
    import contextlib
    import io

    from repro_torch.dist.context import use_mesh
    from repro_torch.launch import train as tlaunch

    extra = ["--ckpt-dir", ckpt] if mesh.data == 2 else []
    with use_mesh(mesh), contextlib.redirect_stdout(io.StringIO()):
        return tlaunch.main(argv + ["--steps", "2"] + extra)["train"]


def train_rank(mesh, payload: dict) -> dict:
    """One rank of ``test_torch_lm_mesh_train.py``: the collectives,
    ``_data_reduce``, the optimizers over blocks, each LM case, the
    launcher."""
    return {"collectives": collective_pieces(mesh),
            "data_reduce": data_reduce_pieces(mesh),
            "optim": optimizer_blocks(mesh, payload["optim_seed"]),
            "runs": {name: train_run(name, p, b, mesh, store)
                     for name, (p, b, store) in payload["runs"].items()},
            "launch": launch_rank(mesh, payload["launch"],
                                  payload["ckpt"])}
