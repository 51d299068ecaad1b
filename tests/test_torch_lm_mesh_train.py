"""The LMs trained under a (data, model) mesh on 4 gloo ranks (CPU): the
port's Trainer steps on every leaf's ``lm_rules`` block (ZeRO-3 storage
over 'data', Megatron tensor parallelism over 'model', the token table and
the cross-entropy vocab-parallel), for the smoke configs of tinyllama-1.1b
(GQA; 2 KV heads, so at (1, 4) ``wk`` / ``wv`` are gathered whole over
'model'), deepseek-v3-671b (MLA + MoE, ``adafactor``), llama4-scout (GQA +
MoE) and tinyllama with an LMA token table (sparse and dense pool
gradients), remat on and the loss in two chunks, at (1, 4) and (2, 2).

Over 3 steps of the launcher's optimizer, from the reference's parameters
(numpy, ``convert.lm_params_from_jax(..., train=True)``): each loss within
1e-5 of the reference's, each leaf's step-1 gradient and each leaf after
the 3 steps, assembled from the ranks' blocks (``sharding.assemble``),
within 1e-5 normwise (after the steps over the elements whose gradient
settles the first update; ``test_params_after_steps_match_reference``
says which).  The oracle is the reference's one-device
``jax.grad`` of ``loss_fn`` and its optimizer (the Trainer, for the LMA
pool's sparse path), except for the MoE configs at (2, 2), whose capacity
and aux are per token share: there it is ``jax.grad`` through the
reference's ``moe_apply_sharded`` under four forced host devices, in
``lm_mesh_reference.py``'s own process.

Also, in float64 on the same ranks: each gradient-carrying collective
(``gather_t``, ``scatter_t``, ``enter_model``, ``leave_model``) against a
numpy evaluation, its backward equal to its transpose's forward; every
rank's blocks tile each leaf and each optimizer-state leaf (every element
held by the same number of ranks, replicas bit-equal); ``_data_reduce``
folds a leaf replicated over 'data' and leaves a ZeRO-3 block as it is;
``adafactor`` (factored, unfactored, transposed, a stacked expert leaf, a
two-layer clip unit) and ``chain(clip_by_global_norm, adam)`` over blocks
within 1e-6 of one process on the whole leaves; and the launcher on an LM
arch under the mesh, saved at (2, 2) and resumed in one process.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lm_mesh_ranks as lr  # noqa: E402
from test_torch_lm_train import _jinit, _np  # noqa: E402
from repro.configs._recsys_common import embedding_of_kind as j_emb  # noqa: E402
from repro.configs.base import get_config as j_get  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402
from repro_torch.dist.sharding import (assemble, block, mesh_at,  # noqa: E402
                                       spec_axes)
from repro_torch.optim import optimizers as ol  # noqa: E402

REF = Path(__file__).resolve().parent / "lm_mesh_reference.py"
MOE = ("deepseek-v3-671b", "llama4-scout-17b-a16e")
OPTIM_SEED = 5
# the share of a leaf whose step-1 gradient may leave the update unsettled
UNSETTLED_SHARE = 0.01
LAUNCH = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--batch", "4"]


def _jcfg(name: str):
    """The reference's config of case ``name``, as ``lr.train_config``."""
    arch = name.split("+")[0]
    jcfg = j_get(arch).make_smoke()
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=jcfg.moe.n_experts / jcfg.moe.top_k
            * 1.05))
    if "+lma" in name:
        jcfg = dataclasses.replace(jcfg, embedding=j_emb(
            "lma", (jcfg.vocab_size,), jcfg.d_model, expansion=16.0,
            max_set=32))
    return dataclasses.replace(jcfg, remat=True, loss_chunk=lr.TRAIN_S // 2)


def _one_device(name: str, jcfg, params, batches, jbufs) -> dict:
    """The reference on one device: the first step's ``jax.grad`` and 3
    steps of the launcher's optimizer (the Trainer's for the LMA pool)."""
    arch = j_get(name.split("+")[0])

    def lf(p, t, y):
        return jt.loss_fn(p, jcfg, t, y, jbufs)[0]
    vg = jax.jit(jax.value_and_grad(lf))
    _, grads = vg(params, jnp.asarray(batches["tokens"][0]),
                  jnp.asarray(batches["labels"][0]))
    out = {"grads": _np(grads)}
    if jbufs is not None:
        tr = JTrainer(JTrainerConfig(total_steps=0, log_every=0),
                      lambda p, b: jt.loss_fn(p, jcfg, b["tokens"],
                                              b["labels"], jbufs),
                      params, jlaunch.make_optimizer(arch),
                      lambda s: {k: jnp.asarray(v[s])
                                 for k, v in batches.items()},
                      sparse_grads=not name.endswith(":dense"))
        losses = []
        for s in range(1, lr.TRAIN_STEPS + 1):
            tr.cfg.total_steps = s
            losses.append(tr.fit(log=lambda _: None)["loss"])
        return out | {"losses": losses, "params": _np(tr.params)}
    opt = jlaunch.make_optimizer(arch)
    update = jax.jit(opt.update)
    state, losses = opt.init(params), []
    for s in range(lr.TRAIN_STEPS):
        loss, g = vg(params, jnp.asarray(batches["tokens"][s]),
                     jnp.asarray(batches["labels"][s]))
        losses.append(float(loss))
        upd, state = update(g, state, params)
        params = jopt.apply_updates(params, upd)
    return out | {"losses": losses, "params": _np(params)}


@pytest.fixture(scope="module")
def runs():
    cases, refs, meshed = {}, {}, {}
    for i, name in enumerate(lr.TRAIN_CASES):
        jcfg = _jcfg(name)
        params = _jinit(jcfg, 40 + i)
        batches = lr.train_batches(jcfg.vocab_size, 50 + i)
        jbufs = store = None
        if "+lma" in name:
            store = _np(JTable(jcfg.embedding).make_buffers(
                synthetic_dense_store(jcfg.vocab_size, 16, max_set=32,
                                      seed=i)))
            jbufs = jax.tree_util.tree_map(jnp.asarray, store)
        cases[name] = (jcfg, params, batches, jbufs, store)
    tmp = tempfile.mkdtemp(prefix="lm-mesh-train-")
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump({n: (c[0], _np(c[1]), c[2]) for n, c in cases.items()
                     if n in MOE}, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(REF),
                            os.path.join(tmp, "out.pkl"), "train",
                            os.path.join(tmp, "in.pkl")], env=env)
    payload = {"optim_seed": OPTIM_SEED, "launch": LAUNCH,
               "ckpt": os.path.join(tmp, "ckpt"),
               "runs": {n: (_np(c[1]), c[2], c[4])
                        for n, c in cases.items()}}
    ranks, err = {}, []

    def spawn(D, M):
        try:
            ranks[D, M] = run_ranks(lr.train_rank, D * M, payload, data=D,
                                    device="cpu")
        except BaseException as e:          # re-raised below
            err.append(e)
    threads = [threading.Thread(target=spawn, args=m)
               for m in lr.TRAIN_MESHES]
    for t in threads:
        t.start()
    for name, (jcfg, params, batches, jbufs, _) in cases.items():
        refs[name] = _one_device(name, jcfg, params, batches, jbufs)
    for t in threads:
        t.join()
    assert ref.wait(timeout=600) == 0, "the meshed reference failed"
    with open(os.path.join(tmp, "out.pkl"), "rb") as f:
        meshed = pickle.load(f)
    if err:
        raise err[0]
    return {"cases": cases, "refs": refs, "meshed": meshed, "ranks": ranks,
            "ckpt": payload["ckpt"]}


def _oracle(runs, mesh, name) -> dict:
    if mesh == (2, 2) and name in MOE:
        return runs["meshed"][name]
    return runs["refs"][name]


def _port(tree, name) -> dict:
    """A reference tree (numpy) in the port's names and layout."""
    cfg = lr.train_config(name)
    return {k: v.to(torch.float32).numpy()
            for k, v in lm_params_from_jax(tree, cfg, "cpu").items()}


def _whole(ranks, mesh, name, what: str) -> dict:
    runs = [r["runs"][name] for r in ranks]
    specs = runs[0]["specs"]
    return {k: assemble([r[what][k] for r in runs], specs[k], mesh)
            for k in runs[0][what]}


def _normwise(got: dict, want: dict, tol: float, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        diff = np.linalg.norm(got[k].astype(np.float64) - want[k])
        ref = np.linalg.norm(want[k].astype(np.float64))
        assert diff <= tol * max(ref, 1e-30), (what, k, diff, ref)


CASES = [(m, n) for m in lr.TRAIN_MESHES for n in lr.TRAIN_CASES]
IDS = [f"{m[0]}x{m[1]}-{n}" for m, n in CASES]


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_losses_match_reference(runs, mesh, name):
    want = _oracle(runs, mesh, name)["losses"]
    for r in runs["ranks"][mesh]:
        got = r["runs"][name]["losses"]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert r["runs"][name]["sparse"] == (
            "+lma" in name and not name.endswith(":dense"))


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_step1_gradients_match_reference(runs, mesh, name):
    got = _whole(runs["ranks"][mesh], mesh, name, "grads")
    _normwise(got, _port(_oracle(runs, mesh, name)["grads"], name), 1e-5,
              f"{mesh} {name} step-1 gradients")


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_params_after_steps_match_reference(runs, mesh, name):
    """Within 1e-5 normwise over the elements whose step-1 gradient
    settles the update: g = 0, or |g| at least 1e-5 of the leaf's rms (the
    tolerance the gradients are held to: below it the sign of g is not
    resolved, and Adam's ``g / (|g| + eps)`` or Adafactor's ``g /
    sqrt(g^2)`` takes either sign on one process as on the mesh) and at
    least 10 of Adam's eps (below it ``g / (|g| + eps)`` multiplies the
    gradient's own error by up to eps / |g|).  The others are at most
    ``UNSETTLED_SHARE`` of each leaf, and each is held to a sign flip of
    every update, 2 lr a step (``chip_smoke.py``'s phase 40 holds its
    float32 steps to the same bound, and to 2% of a leaf at full width,
    where lm_head's share is 1.1%)."""
    oracle = _oracle(runs, mesh, name)
    got = _whole(runs["ranks"][mesh], mesh, name, "params")
    want = _port(oracle["params"], name)
    grads = _port(oracle["grads"], name)
    lr_ = j_get(name.split("+")[0]).learning_rate
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = grads[k]
        rms = np.sqrt(np.mean(np.square(g, dtype=np.float64)))
        sure = (g == 0) | ((np.abs(g) >= 1e-5 * rms) & (np.abs(g) >= 1e-7))
        d = got[k].astype(np.float64) - w
        assert np.linalg.norm(d[sure]) <= 1e-5 * np.linalg.norm(w), (k, mesh)
        assert (~sure).sum() <= UNSETTLED_SHARE * g.size, (k, (~sure).sum())
        assert np.all(np.abs(d[~sure]) <= 2 * lr_ * lr.TRAIN_STEPS), k


def _tiles(blocks: list, spec: tuple, mesh: tuple) -> None:
    """Every element of the whole leaf is held by the same number of
    ranks (the replicas over the axes ``spec`` leaves out), and replicas
    hold the same bits."""
    whole = assemble(blocks, spec, mesh)
    held = np.zeros(whole.shape, np.int64)
    for r, b in enumerate(blocks):
        m = mesh_at(mesh, r)
        block(held, m, spec)[...] += 1
        np.testing.assert_array_equal(block(whole, m, spec).view(np.int32),
                                      np.asarray(b).view(np.int32))
    used = {a for i in range(len(spec)) for a in spec_axes(spec, i)}
    reps = (1 if "data" in used else mesh[0]) * (1 if "model" in used
                                                 else mesh[1])
    assert (held == reps).all()


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_blocks_tile_every_leaf_and_state(runs, mesh, name):
    ranks = [r["runs"][name] for r in runs["ranks"][mesh]]
    specs = ranks[0]["specs"]
    assert all(s is not None for s in specs.values())
    for k, spec in specs.items():
        _tiles([r["params"][k] for r in ranks], spec, mesh)
    # each optimizer-state tensor under a parameter's path with its block's
    # shape (Adam's moments, Adafactor's unfactored v) tiles by its spec
    n = 0
    for path in ranks[0]["opt"]:
        for k, spec in specs.items():
            if f"/{k}/" in f"/{path}/" and \
                    ranks[0]["opt"][path].shape == ranks[0]["params"][k].shape:
                _tiles([r["opt"][path] for r in ranks], spec, mesh)
                n += 1
                break
    assert n >= len(specs)


@pytest.mark.parametrize("mesh", lr.TRAIN_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collectives_backward_is_the_transpose(runs, mesh):
    ranks = [r["collectives"] for r in runs["ranks"][mesh]]
    D, M = mesh
    world = D * M
    for key in ranks[0]:
        if key == "model":
            continue
        axis, dim = key
        members = {
            "model": lambda r: [r // M * M + m for m in range(M)],
            "data": lambda r: [d * M + r % M for d in range(D)],
        }.get(axis, lambda r: list(range(world)))
        for r in range(world):
            grp = members(r)
            me = grp.index(r)
            got = ranks[r][key]
            xs = [ranks[j][key]["x"] for j in grp]
            np.testing.assert_array_equal(got["gather"],
                                          np.concatenate(xs, axis=dim))
            cts = sum(ranks[j][key]["gather_ct"] for j in grp)
            want = np.split(cts, len(grp), axis=dim)[me]
            np.testing.assert_allclose(got["gather_bwd"], want, rtol=1e-12,
                                       atol=1e-12)
            np.testing.assert_array_equal(got["gather_bwd"],
                                          got["scatter_of_ct"])
            np.testing.assert_allclose(
                got["scatter"], np.split(sum(xs), len(grp), axis=dim)[me],
                rtol=1e-12, atol=1e-12)
            np.testing.assert_array_equal(
                got["scatter_bwd"], np.concatenate(
                    [ranks[j][key]["scatter_ct"] for j in grp], axis=dim))
            np.testing.assert_array_equal(got["scatter_bwd"],
                                          got["gather_of_ct"])
    for r in range(world):
        got = ranks[r]["model"]
        grp = [r // M * M + m for m in range(M)]
        total = sum(ranks[j]["model"]["ct"] for j in grp)
        np.testing.assert_allclose(got["enter_bwd"], total, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(got["enter_bwd"], got["leave_of_ct"])
        np.testing.assert_allclose(
            got["leave"], sum(ranks[j]["model"]["x"] for j in grp),
            rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(got["leave_bwd"], got["ct"])


@pytest.mark.parametrize("mesh", lr.TRAIN_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_data_reduce_leaves_zero3_blocks(runs, mesh):
    D, M = mesh
    for r, out in enumerate(runs["ranks"][mesh]):
        x = np.arange(4, dtype=np.float32)
        np.testing.assert_array_equal(out["data_reduce"]["zero3"],
                                      x + 100 * r)
        folded = sum(x + 100 * (d * M + r % M) for d in range(D))
        np.testing.assert_array_equal(out["data_reduce"]["replicated"],
                                      folded)
        assert out["data_reduce"]["loss"] == pytest.approx(
            sum(1.0 + d for d in range(D)) / D)


@pytest.mark.parametrize("mesh,kind", [(m, k) for m in lr.TRAIN_MESHES
                                       for k in ("adafactor", "clip_adam")],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(
                             v, tuple) else v)
def test_optimizers_over_blocks(runs, mesh, kind):
    params, grads = lr.adafactor_leaves(OPTIM_SEED)
    opt = ol.adafactor(1e-2) if kind == "adafactor" else ol.chain(
        ol.clip_by_global_norm(0.5), ol.adam(1e-2))
    ps = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in
          params.items()}
    st = opt.init(ps)
    want = []
    for g in grads:
        u, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                           st, ps)
        want.append({k: x.numpy() for k, x in u.items()})
    ranks = [r["optim"][kind] for r in runs["ranks"][mesh]]
    specs = ranks[0]["specs"]
    for s, w in enumerate(want):
        got = {k: assemble([r["updates"][s][k] for r in ranks], specs[k],
                           mesh) for k in w}
        _normwise(got, w, 1e-6, f"{kind} step {s + 1}")
    if kind == "adafactor":
        # the factored statistics are whole, and the same, on every rank
        for path, v in ranks[0]["state"].items():
            if path.endswith(("v_row", "v_col")):
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r["state"][path], v)


def test_launcher_under_mesh_resumes_in_one_process(runs):
    from repro_torch.launch import train as tlaunch
    meshed = {m: [r["launch"] for r in runs["ranks"][m]]
              for m in lr.TRAIN_MESHES}
    one = tlaunch.main(LAUNCH + ["--steps", "2"])["train"]["loss"]
    for m, outs in meshed.items():
        for o in outs:
            assert o["loss"] == pytest.approx(one, rel=0, abs=1e-5), m
    straight = tlaunch.main(LAUNCH + ["--steps", "3"])["train"]["loss"]
    resumed = tlaunch.main(LAUNCH + ["--steps", "3", "--ckpt-dir",
                                     runs["ckpt"]])["train"]["loss"]
    assert resumed == pytest.approx(straight, rel=0, abs=1e-5)


@pytest.mark.parametrize("convert", ["deepcopy", "to", "to-overwrite",
                                     "to-swap"])
def test_stored_blocks_survive_copy_and_conversion(convert):
    """A model stored for training under a mesh keeps every leaf's layout
    (a ``StoredBlock``, its spec and mesh) and values through a deep copy
    and through ``.to()``, also where ``torch.__future__`` has the
    conversion overwrite or swap the parameters."""
    import copy

    from repro_torch.dist.sharding import StoredBlock
    from repro_torch.models import transformer as tt

    mesh = mesh_at((2, 2), 3)
    model = tt.init(lr.train_config("tinyllama-1.1b"), 0, "cpu", mesh=mesh,
                    train=True)
    before = {k: (p.spec, p.detach().clone())
              for k, p in model.named_parameters()}
    assert all(isinstance(p, StoredBlock) for p in model.parameters())
    if convert == "deepcopy":
        model = copy.deepcopy(model)
    else:
        fut = torch.__future__
        flags = (fut.get_overwrite_module_params_on_conversion(),
                 fut.get_swap_module_params_on_conversion())
        fut.set_overwrite_module_params_on_conversion(
            convert == "to-overwrite")
        fut.set_swap_module_params_on_conversion(convert == "to-swap")
        try:
            model = model.to(torch.float64)
        finally:
            fut.set_overwrite_module_params_on_conversion(flags[0])
            fut.set_swap_module_params_on_conversion(flags[1])
    got = dict(model.named_parameters())
    assert got.keys() == before.keys()
    for k, (spec, value) in before.items():
        p = got[k]
        assert isinstance(p, StoredBlock) and p.spec == spec, (convert, k)
        assert p.mesh is mesh and p.requires_grad, (convert, k)
        assert torch.equal(p.detach().to(value.dtype), value), (convert, k)
