"""Port dot_interaction module (CPU path) vs the JAX model's einsum
(``recsys.dot_interaction``) and the Pallas kernel in interpret mode."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dot_interaction.kernel import \
    dot_interaction_pallas  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.kernels.dot_interaction import ops  # noqa: E402


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
