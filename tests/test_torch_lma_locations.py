"""Port lma_locations module (CPU path) vs the JAX Pallas kernel in
interpret mode and its jnp reference: bit-identical locations."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.allocation import LMAParams as JParams  # noqa: E402
from repro.core.hashing import seed_stream  # noqa: E402
from repro.kernels.lma_locations import ops as jops  # noqa: E402
from repro.kernels.lma_locations.kernel import \
    lma_locations_pallas  # noqa: E402
from repro_torch.core.allocation import LMAParams  # noqa: E402
from repro_torch.kernels.lma_locations import ops  # noqa: E402

D, M = 16, 8192


def _sets(n, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (n, s), dtype=np.uint64).astype(np.uint32)
    x[:, 0] |= np.uint32(1 << 31)
    lens = rng.integers(0, s + 1, n)
    x[np.arange(s)[None, :] >= lens[:, None]] = 0xFFFFFFFF
    x[:2] = 0xFFFFFFFF
    return x


@pytest.mark.parametrize("independent", [True, False])
@pytest.mark.parametrize("striped", [False, True])
def test_lma_locations_matches_pallas_interpret(independent, striped):
    kw = dict(d=D, m=M, n_h=3, max_set=12, seed=0xA000_0005,
              independent_hashes=independent, striped=striped)
    jp, tp = JParams(**kw), LMAParams(**kw)
    sets = _sets(70, 12, seed=int(independent) + 2 * int(striped))
    got = ops.lma_locations(tp, torch.from_numpy(sets.view(np.int32)))
    want = lma_locations_pallas(
        jp, jnp.asarray(sets), seed_stream(jp.seed, jp.n_raw_hashes),
        seed_stream(jp.seed ^ 0x7F4A7C15, jp.d), block_b=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.reference(jp, jnp.asarray(sets))))


def test_lma_gather_matches_reference():
    kw = dict(d=D, m=M, n_h=4, max_set=8, seed=0x5C3A, striped=True)
    jp, tp = JParams(**kw), LMAParams(**kw)
    sets = _sets(40, 8, seed=5)
    mem = np.random.default_rng(0).normal(size=M).astype(np.float32)
    got = ops.lma_gather(tp, torch.from_numpy(mem),
                         torch.from_numpy(sets.view(np.int32)))
    want = jops.lma_gather(jp, jnp.asarray(mem), jnp.asarray(sets), True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unsupported_device_raises():
    sets = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.lma_locations(LMAParams(d=D, m=M), sets)
