"""The LM served under a (data, model) mesh on 4 gloo ranks (CPU): the
port's ``moe_apply_sharded``, its rule tables (``lm_rules``,
``LM_CACHE_RULES``) and ``rank_share``, and an LMA token table.

- ``moe_apply_sharded`` against the reference's live one on 4 forced host
  devices (one subprocess for the file, ``lm_mesh_reference.py``), on the
  (1, 4), (2, 2) and (4, 1) meshes: with and without
  ``full_token_sharding``, tokens replicated, dp-sharded and full-mesh,
  capacities that drop; outputs within 1e-6 normwise, aux within 1e-6.
  Capacity and aux are per token share by design, so the sharded MoE is
  held to the sharded reference, not to ``moe_apply``.
- The resolved specs equal the reference's for every parameter and cache
  leaf of the three smoke configs, on ``AbstractMesh`` (1, 4), (2, 2) and
  (4, 1); ``_moe_w_specs`` too.
- The whole model: ``test_torch_lm_mesh_model.py``.
- An LMA token table under (2, 2): ``embed_tokens`` through psum, ring
  and all_to_all bit-equal to the one-card split path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import lm_mesh_ranks as lr  # noqa: E402
from test_torch_flash_decode import finish, reference  # noqa: E402
from test_torch_lm_transformer import _jinit, _np  # noqa: E402
from repro.configs._recsys_common import embedding_of_kind as j_emb  # noqa: E402
from repro.configs.base import get_config as j_get  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.launch.steps import LM_CACHE_RULES as J_CACHE_RULES  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.configs._recsys_common import \
    embedding_of_kind as t_emb  # noqa: E402
from repro_torch.convert import buffers_from_numpy  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402
from repro_torch.dist.context import Mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402


# ------------------------------------------------------------ the MoE

@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe") / "ref.npz"
    proc = reference(path, "moe")
    ranks = {m: run_ranks(lr.moe_rank, m[0] * m[1], m, data=m[0],
                          device="cpu") for m in lr.MESHES}
    return ranks, finish(proc, path)


@pytest.mark.parametrize("mesh", lr.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_apply_sharded_matches_reference(moe_runs, mesh):
    ranks, ref = moe_runs
    tag = f"{mesh[0]}x{mesh[1]}"
    drops = 0
    for i, case in enumerate(lr.moe_cases(mesh)):
        want = ref[f"moe/{tag}/{i}/out"]
        for r in ranks[mesh]:
            got = r[i]["out"]
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err < 1e-6, (tag, case, err)
            np.testing.assert_allclose(r[i]["aux"],
                                       float(ref[f"moe/{tag}/{i}/aux"]),
                                       rtol=1e-6, atol=1e-6)
            # a rank stores only its storage block of each stack
            sg, _ = tmoe._moe_w_specs(lr.moe_config(case),
                                      Mesh(model=mesh[1], data=mesh[0]))
            n = tsh.axes_size(Mesh(model=mesh[1], data=mesh[0]),
                              tsh.spec_axes(sg, 0))
            assert r[i]["stored"][0] == case["E"] // n
        drops += ranks[mesh][0][i]["dropped"]
    assert drops > 0, "no case dropped a token"


# ------------------------------------------------------------ collectives

def test_axis_set_collectives():
    """``psum`` over 'model', 'data' and ('data', 'model') (the world),
    ``psum_scatter`` over 'model', on a (2, 2) mesh."""
    ranks = run_ranks(lr.collectives_rank, 4, data=2, device="cpu")
    xs = [np.arange(8, dtype=np.float32) + 10 * w for w in range(4)]
    for w, r in enumerate(ranks):
        d, m = divmod(w, 2)
        model = [xs[d * 2 + j] for j in range(2)]
        data = [xs[j * 2 + m] for j in range(2)]
        groups = {"model": model, ("model",): model, ("data",): data,
                  "data": data, ("data", "model"): xs}
        for a, got in r["psum"].items():
            np.testing.assert_array_equal(got, np.sum(groups[a], axis=0))
        np.testing.assert_array_equal(r["scatter"],
                                      np.sum(model, axis=0)[m * 4:m * 4 + 4])


# ------------------------------------------------------------ rule tables

def _amesh(D, M):
    return jax.sharding.AbstractMesh((D, M), ("data", "model"))


@pytest.mark.parametrize("arch", lr.LM_ARCHS)
def test_rule_tables_match_reference(arch):
    jcfg = j_get(arch).make_smoke()
    tcfg = lr.lm_config(arch, False)
    shapes = jax.eval_shape(lambda: jt.init(jax.random.key(0), jcfg))
    paths, leaves, _ = jsh.tree_path_strings(shapes)
    caches = [jax.eval_shape(lambda: jt.init_cache(jcfg, B, L))
              for B, L in ((4, 16), (1, 64), (3, 18))]
    n = 0
    for D, M in lr.MESHES:
        am, pm = _amesh(D, M), Mesh(model=M, data=D)
        for path, leaf in zip(paths, leaves):
            want = tuple(jsh.spec_for_path(path, leaf.shape, jsh.lm_rules(),
                                           am))
            got = tsh.spec_for_path(path, leaf.shape, tsh.lm_rules(), pm)
            assert got == want, (arch, (D, M), path)
            n += 1
        for cache in caches:
            cp, cl, _ = jsh.tree_path_strings(cache)
            for path, leaf in zip(cp, cl):
                want = tuple(jsh.spec_for_path(path, leaf.shape,
                                               J_CACHE_RULES, am))
                got = tsh.spec_for_path(path, leaf.shape,
                                        tsh.LM_CACHE_RULES, pm)
                assert got == want, (arch, (D, M), path)
                n += 1
        if jcfg.moe is not None:
            want = tuple(tuple(s) for s in jmoe._moe_w_specs(jcfg.moe, am))
            assert tmoe._moe_w_specs(tcfg.moe, pm) == want
    assert n > 0


def test_rank_share_cuts_blocks():
    """``rank_share`` by ``lm_rules``: an expert stack's storage block and
    the LMA pool's 'model' slab, every rank's blocks tiling the leaf."""
    w = np.arange(1 * 8 * 4 * 6).reshape(1, 8, 4, 6)
    pool = np.arange(32)
    for D, M in lr.MESHES:
        blocks, slabs = [], []
        for wr in range(D * M):
            mesh = Mesh(model=M, rank=wr % M, data=D, data_rank=wr // M)
            blocks.append(tsh.rank_share("/layers_1/moe/w_gate", w, mesh,
                                         tsh.lm_rules()))
            slabs.append(tsh.rank_share("/embed/memory", pool, mesh,
                                        tsh.lm_rules()))
        np.testing.assert_array_equal(np.concatenate(blocks, axis=1), w)
        np.testing.assert_array_equal(np.concatenate(slabs[:M]), pool)


# ------------------------------------------------------------ the LMA table

def test_lma_token_table_under_a_mesh():
    base_j = j_get("tinyllama-1.1b").make_smoke()
    V, d = base_j.vocab_size, base_j.d_model
    jcfg = dataclasses.replace(base_j, embedding=j_emb(
        "lma", (V,), d, expansion=16.0, max_set=32))
    e = t_emb("lma", (V,), d, expansion=16.0, max_set=32)
    tcfg = lr.lm_config("tinyllama-1.1b", False, embedding=e)
    store = synthetic_dense_store(V, 16, max_set=32, seed=0)
    jb = _np(JTable(jcfg.embedding).make_buffers(store))
    pool = _np(_jinit(jcfg, 3))["embed"]["memory"]
    tok = np.random.default_rng(5).integers(0, V, (3, 8)).astype(np.int32)
    model = tt.init(tcfg, device="cpu")
    with torch.no_grad():
        model.embed["memory"].copy_(torch.from_numpy(np.array(pool)))
        want = tt.embed_tokens(model, tcfg, torch.from_numpy(tok),
                               buffers_from_numpy(jb, "cpu")).numpy()
    ranks = run_ranks(lr.lma_rank, 4, tcfg, pool, jb, tok, data=2,
                      device="cpu")
    for r in ranks:
        for strategy, (got, ran) in r.items():
            assert ran == strategy
            np.testing.assert_array_equal(got, want, err_msg=strategy)
