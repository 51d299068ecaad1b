"""Port dot_interaction module (CPU path) vs the JAX model's einsum
(``recsys.dot_interaction``) and the Pallas kernel in interpret mode; the
CUDA kernel's tile list and schedule against the plain version."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dot_interaction.kernel import \
    dot_interaction_pallas  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from kernel_schedules import dot_interaction_schedule  # noqa: E402
from repro_torch.kernels.dot_interaction import kernel as dk  # noqa: E402
from repro_torch.kernels.dot_interaction import ops  # noqa: E402
from repro_torch.kernels.dot_interaction.ref import \
    dot_interaction_ref  # noqa: E402


@pytest.mark.parametrize("B,F,d", [(16, 27, 64), (8, 5, 16), (3, 2, 7)])
def test_dot_interaction_matches_reference_and_pallas(B, F, d):
    # features at the model's scale: embeddings ~ 1/sqrt(d) per entry
    x = np.random.default_rng(F).normal(0, d ** -0.5,
                                        (B, F, d)).astype(np.float32)
    got = ops.dot_interaction(torch.from_numpy(x)).numpy()
    assert got.shape == (B, F * (F - 1) // 2)
    np.testing.assert_allclose(
        got, np.asarray(jrec.dot_interaction(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(dot_interaction_pallas(jnp.asarray(x), block_b=B,
                                               interpret=True)),
        rtol=1e-6, atol=1e-6)


def test_dot_interaction_packed_order():
    """Pair p of the packed row is (i, j) of np.tril_indices(F, -1)."""
    F, d = 6, 4
    x = torch.randn((2, F, d), generator=torch.Generator().manual_seed(0))
    got = ops.dot_interaction(x)
    p = 0
    for i in range(F):
        for j in range(i):
            torch.testing.assert_close(got[:, p], (x[:, i] * x[:, j]).sum(-1))
            p += 1
    assert p == got.shape[1]


# ---- the CUDA kernel's schedule (csrc/dot_interaction.cu), on the CPU ----


@pytest.mark.parametrize("F", [2, 3, 5, 27, 39])
def test_dot_tiles_cover_each_pair_once(F):
    """The binding's tile list covers every pair of np.tril_indices(F, -1)
    exactly once, and the packed place the kernel writes is the pair's."""
    ii, jj = np.tril_indices(F, k=-1)
    where = {(int(i), int(j)): p for p, (i, j) in enumerate(zip(ii, jj))}
    seen = []
    for tile in dk.dot_tiles(F).tolist():
        i0, j0, nt = tile & 0x3FF, (tile >> 10) & 0x3FF, tile >> 20
        for i in range(i0, i0 + dk.TI):
            for j in range(j0, j0 + dk.TJ * nt, nt):
                if i < F and j < i:      # the pairs the kernel writes
                    assert where[(i, j)] == i * (i - 1) // 2 + j
                    seen.append((i, j))
    assert sorted(seen) == sorted(where)


@pytest.mark.parametrize("d", [7, 16, 64])
@pytest.mark.parametrize("B", [1, 5, 17])
def test_dot_schedule_matches_plain(B, d):
    """Groups of G samples (both sizes the binding picks) over a persistent
    grid, the tiles and each group's output span reproduce the plain
    version."""
    F = 27
    x = torch.from_numpy(np.random.default_rng(B * d).normal(
        0, d ** -0.5, (B, F, d)).astype(np.float32))
    for G in (1, dk.GROUP):
        for grid in (1, 3):
            got = dot_interaction_schedule(x, G, grid, dk.dot_tiles(F))
            torch.testing.assert_close(got, dot_interaction_ref(x),
                                       rtol=1e-5, atol=1e-6)


def test_dot_group_size_and_shared_memory():
    """G = 4 from 64 samples an SM on, 1 below that or where four samples
    do not fit a block; the 48 KB static limit is gone."""
    assert dk.group_size(4096, 27, 64, True, sms=132) == 1
    assert dk.group_size(65536, 27, 64, True, sms=132) == dk.GROUP
    assert dk.group_size(17, 27, 7, False, sms=1) == 1
    assert dk.group_size(64, 27, 7, False, sms=1) == dk.GROUP
    assert dk.smem_bytes(27, 64, 4, True) == 4 * (1404 + 2 * 4 * 27 * 68)
    assert dk.smem_bytes(100, 128, 1, True) > 48 * 1024
    assert dk.group_size(65536, 100, 128, True, sms=132) == 1
    assert dk.row_stride(64, True) == 68 and dk.row_stride(12, True) == 12
    assert dk.row_stride(7, False) == 7 and dk.row_stride(10, False) == 11
