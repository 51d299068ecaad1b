"""Port fused_embed module (CPU path) vs the JAX fused engine (Pallas in
interpret mode): lookups bit-identical, bags within 1e-6."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.allocation import LMAParams as JParams  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.kernels.fused_embed import ops as jfe  # noqa: E402
from repro_torch.core.allocation import LMAParams  # noqa: E402
from repro_torch.kernels.fused_embed import ops as fe  # noqa: E402

N_VALUES, D, M = 512, 16, 8192


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy((x.view(np.int32) if x.dtype == np.uint32
                             else x).copy())


def _fixture(seed):
    rng = np.random.default_rng(seed)
    mem = rng.normal(0, 0.1, M).astype(np.float32)
    store = synthetic_dense_store(N_VALUES, 8, max_set=16, seed=1)
    sets = np.asarray(store.sets)
    support = np.asarray(store.lengths).copy()
    support[::7] = rng.integers(0, 2, len(support[::7]))   # fallback rows
    return rng, mem, sets, support


@pytest.mark.parametrize("striped", [False, True])
@pytest.mark.parametrize("B", [8, 67])
def test_lma_fused_lookup_bit_identical(striped, B):
    rng, mem, sets, support = _fixture(B)
    kw = dict(d=D, m=M, n_h=4, max_set=16, seed=0x8000_0007, striped=striped)
    gids = rng.integers(0, N_VALUES, B).astype(np.int32)
    gids[0] = 0                                   # a fallback row
    rows, sup = sets[gids], support[gids]
    assert (sup < 2).any()
    got = fe.fused_lookup(fe.lma_spec(LMAParams(**kw)), _t(mem), _t(gids),
                          _t(rows), _t(sup))
    want = jfe.fused_lookup(jfe.lma_spec(JParams(**kw)), jnp.asarray(mem),
                            jnp.asarray(gids), jnp.asarray(rows),
                            jnp.asarray(sup), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", ["hashed_elem", "hashed_row"])
def test_hashed_fused_lookup_bit_identical(scheme):
    rng, mem, _, _ = _fixture(3)
    gids = rng.integers(0, 2**31 - 1, 50).astype(np.int32)
    got = fe.fused_lookup(fe.hashed_spec(scheme, D, M, 0xFEED_0001),
                          _t(mem), _t(gids))
    want = jfe.fused_lookup(jfe.hashed_spec(scheme, D, M, 0xFEED_0001),
                            jnp.asarray(mem), jnp.asarray(gids),
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", ["lma", "hashed_elem"])
def test_fused_embed_bag_within_1e6(scheme):
    rng, mem, sets, support = _fixture(4)
    B, L = 6, 5
    gids = rng.integers(0, N_VALUES, (B, L)).astype(np.int32)
    w = (rng.random((B, L)) < 0.8).astype(np.float32) * rng.random((B, L),
                                                                   np.float32)
    if scheme == "lma":
        kw = dict(d=D, m=M, n_h=4, max_set=16, seed=7, striped=True)
        tspec, jspec = fe.lma_spec(LMAParams(**kw)), jfe.lma_spec(JParams(**kw))
        extra = (sets[gids], support[gids])
    else:
        tspec = fe.hashed_spec(scheme, D, M, 11)
        jspec = jfe.hashed_spec(scheme, D, M, 11)
        extra = ()
    got = fe.fused_embed_bag(tspec, _t(mem), _t(gids), _t(w),
                             *[_t(a) for a in extra])
    want = jfe.fused_embed_bag(jspec, jnp.asarray(mem), jnp.asarray(gids),
                               jnp.asarray(w),
                               *[jnp.asarray(a) for a in extra],
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_spec_fields_match_reference():
    kw = dict(d=64, m=135_053_312, n_h=4, max_set=32, seed=0, striped=True)
    t, j = fe.lma_spec(LMAParams(**kw)), jfe.lma_spec(JParams(**kw))
    assert (t.stripe, t.n_raw_hashes) == (j.stripe, j.n_raw_hashes) \
        == (2_110_208, 256)
    with pytest.raises(ValueError):
        fe.hashed_spec("lma", D, M, 0)
