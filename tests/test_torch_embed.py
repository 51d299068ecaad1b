"""Port embedding facade vs the JAX reference, parameters carried across as
numpy: ``embed`` / ``embed_fields`` bit-identical, ``embed_bag`` (sum and
mean) within 1e-6, for every scheme of this slice."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import _recsys_common as jrc  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro_torch.configs import _recsys_common as trc  # noqa: E402
from repro_torch.convert import buffers_from_numpy  # noqa: E402
from repro_torch.embed import SPLIT, EmbeddingTable, resolve_backend  # noqa: E402

KINDS = ["full", "hashed_elem", "hashed_row", "lma"]
VOCABS = trc.smoke_vocabs(6)


def _pair(kind):
    kw = dict(expansion=8.0, max_set=16)
    jcfg = jrc.embedding_of_kind(kind, VOCABS, 16, **kw)
    tcfg = trc.embedding_of_kind(kind, VOCABS, 16, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jt, tt = JTable(jcfg), EmbeddingTable(tcfg)
    jparams = jt.init(jax.random.key(0))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    jbufs, tbufs = {}, {}
    if kind == "lma":
        store = synthetic_dense_store(jcfg.total_vocab, 8, max_set=16, seed=2)
        lengths = np.asarray(store.lengths).copy()
        lengths[::9] = 1                              # very sparse values
        jbufs = {"store_sets": store.sets, "store_lengths": jnp.asarray(lengths)}
        tbufs = buffers_from_numpy({k: np.asarray(v) for k, v in jbufs.items()},
                                   device="cpu")
    return jcfg, jt, tt, jparams, tparams, jbufs, tbufs


def _ids(rng, B):
    return np.stack([rng.integers(0, v, B) for v in VOCABS], 1).astype(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_embed_fields_and_embed_bit_identical(kind):
    _, jt, tt, jp, tp, jb, tb = _pair(kind)
    ids = _ids(np.random.default_rng(0), 40)
    np.testing.assert_array_equal(
        tt.embed_fields(tp, tb, torch.from_numpy(ids)).numpy(),
        np.asarray(jt.embed_fields(jp, jb, jnp.asarray(ids))))
    sub = ids[:, 3].reshape(8, 5)
    np.testing.assert_array_equal(
        tt.embed(tp, tb, 3, torch.from_numpy(sub)).numpy(),
        np.asarray(jt.embed(jp, jb, 3, jnp.asarray(sub))))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embed_bag_within_1e6(kind, mode):
    _, jt, tt, jp, tp, jb, tb = _pair(kind)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCABS[2], (7, 6)).astype(np.int32)
    mask = rng.random((7, 6)) < 0.7
    mask[0] = False                                   # an empty bag
    got = tt.embed_bag(tp, tb, 2, torch.from_numpy(ids),
                       torch.from_numpy(mask), mode)
    want = jt.embed_bag(jp, jb, 2, jnp.asarray(ids), jnp.asarray(mask), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_resolver_and_device_policy():
    jcfg, _, tt, _, tp, _, _ = _pair("hashed_elem")
    assert resolve_backend(tt.config, tp) is SPLIT          # CPU pool
    full = EmbeddingTable(trc.embedding_of_kind("full", VOCABS, 16))
    assert resolve_backend(full.config, {}) is None         # table family
    assert tt.param_count == jcfg.param_count()
    with pytest.raises(ValueError):
        tt.embed_bag(tp, {}, 0, torch.zeros((2, 2), dtype=torch.int32),
                     torch.ones((2, 2), dtype=torch.bool), "max")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):                   # no silent CPU
            tt.init()
