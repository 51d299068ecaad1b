"""The port's embedding bag (``repro_torch.kernels.embedding_bag``, plain
version on the CPU) against the reference's public op (its Pallas kernel in
interpret mode) and its jnp ``embedding_bag_ref``, float32: every output
within 1e-6 of its ``sum_l |w T|`` (the reference sums the one-hot matmul's
tiles, the port gathers and sums in another order).  Shapes include B off
the reference's 128-row block, L past a warp, and a bag of zero weights."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag.ops import embedding_bag as jbag  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as tops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402


def _case(V, d, B, L, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, L), dtype=np.int32)
    w = (rng.random((B, L)) - 0.3).astype(np.float32)
    w[0] = 0.0                                        # an empty bag
    return table, ids, w


@pytest.mark.parametrize("V,d,B,L", [(512, 16, 32, 8), (1024, 64, 128, 20),
                                     (4096, 64, 200, 4), (384, 8, 96, 100),
                                     (1000, 10, 333, 26)])
def test_embedding_bag_matches_reference(V, d, B, L):
    table, ids, w = _case(V, d, B, L, V + B)
    got = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(w)).numpy()
    scale = np.einsum("bl,bld->bd", np.abs(w).astype(np.float64),
                      np.abs(table[ids]).astype(np.float64))
    for want in (jbag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w),
                      True),
                 jref(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w))):
        err = np.abs(got - np.asarray(want)) / np.maximum(scale, 1e-30)
        assert got.shape == (B, d) and float(err.max()) <= 1e-6
    assert not got[0].any()


def test_embedding_bag_is_the_plain_version_on_the_cpu():
    table, ids, w = _case(64, 8, 5, 3, 1)
    args = tuple(map(torch.from_numpy, (table, ids, w)))
    assert torch.equal(tops.embedding_bag(*args), embedding_bag_ref(*args))
    with pytest.raises(ValueError, match="unsupported device"):
        tops.embedding_bag(torch.zeros((4, 2), device="meta"), None, None)
