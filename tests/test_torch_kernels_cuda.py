"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an sm_90 device and skip elsewhere.  They cover what the serving
path at full width does not: sliding windows, the hashed schemes, ragged set
widths, empty sets, and keys and seeds >= 2^31.  On the card, with no JAX
installed, run them as
``python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.allocation import LMAParams  # noqa: E402
from repro_torch.kernels.dot_interaction import ops as dot_ops  # noqa: E402
from repro_torch.kernels.dot_interaction.ref import \
    dot_interaction_ref  # noqa: E402
from repro_torch.kernels.fused_embed import ops as fe  # noqa: E402
from repro_torch.kernels.fused_embed import ref as fref  # noqa: E402
from repro_torch.kernels.lma_locations import ops as loc_ops  # noqa: E402
from repro_torch.kernels.lma_locations.ref import \
    lma_locations_ref  # noqa: E402

M, D = 8192, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")


def _sets(rng, n, s, empty_rows=3):
    """int32 bit patterns with keys >= 2^31, ragged PAD tails, empty rows."""
    x = rng.integers(0, 2**32, (n, s), dtype=np.uint64).astype(np.uint32)
    x[:, 0] |= np.uint32(1 << 31)
    lens = rng.integers(0, s + 1, n)
    x[np.arange(s)[None, :] >= lens[:, None]] = 0xFFFFFFFF
    x[:empty_rows] = 0xFFFFFFFF
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("independent", [True, False])
@pytest.mark.parametrize("striped", [False, True])
@pytest.mark.parametrize("S", [20, 32, 45])
def test_lma_locations_kernel_matches_plain(cuda, independent, striped, S):
    rng = np.random.default_rng(S)
    p = LMAParams(d=D, m=M, n_h=3, max_set=S, seed=0x9000_0013,
                  independent_hashes=independent, striped=striped)
    sets = _sets(rng, 300, S)
    got = loc_ops.lma_locations(p, sets.to(cuda)).cpu()
    want = lma_locations_ref(p, sets)
    assert torch.equal(got, want)


def _mem(cuda, m=M):
    g = torch.Generator(device=cuda).manual_seed(0)
    return torch.randn(m, generator=g, device=cuda)


@pytest.mark.parametrize("striped", [False, True])
def test_fused_lma_lookup_and_bag_match_plain(cuda, striped):
    rng = np.random.default_rng(1)
    p = LMAParams(d=D, m=M, n_h=4, max_set=24, seed=0xF00D_0001,
                  striped=striped, min_support=3)
    spec = fe.lma_spec(p)
    mem = _mem(cuda)
    B, L = 40, 7
    sets = _sets(rng, B * L, 24).to(cuda)
    support = torch.from_numpy(rng.integers(0, 6, B * L).astype(np.int32))
    gids = torch.from_numpy(
        rng.integers(2**31 - 5000, 2**31 - 1, B * L).astype(np.int32))
    support, gids = support.to(cuda), gids.to(cuda)
    assert (support < p.min_support).any()
    got = fe.fused_lookup(spec, mem, gids, sets, support)
    want = fref.fused_lookup_ref(spec, mem, gids, sets, support)
    assert torch.equal(got, want)
    w = torch.from_numpy(rng.random((B, L)).astype(np.float32)).to(cuda)
    bag = fe.fused_embed_bag(spec, mem, gids.reshape(B, L), w,
                             sets.reshape(B, L, 24), support.reshape(B, L))
    bag_want = fref.fused_embed_bag_ref(spec, mem, gids.reshape(B, L), w,
                                        sets.reshape(B, L, 24),
                                        support.reshape(B, L))
    torch.testing.assert_close(bag, bag_want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scheme", ["hashed_elem", "hashed_row"])
def test_fused_hashed_lookup_matches_plain(cuda, scheme):
    rng = np.random.default_rng(2)
    spec = fe.hashed_spec(scheme, D, M, 0x8765_4321)
    mem = _mem(cuda)
    gids = torch.from_numpy(
        rng.integers(0, 2**31 - 1, 500).astype(np.int32)).to(cuda)
    got = fe.fused_lookup(spec, mem, gids)
    assert torch.equal(got, fref.fused_lookup_ref(spec, mem, gids))
    w = torch.ones((50, 10), device=cuda)
    bag = fe.fused_embed_bag(spec, mem, gids.reshape(50, 10), w)
    torch.testing.assert_close(
        bag, fref.fused_embed_bag_ref(spec, mem, gids.reshape(50, 10), w),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("F,d", [(27, 64), (5, 16), (2, 3)])
def test_dot_interaction_kernel_matches_plain(cuda, F, d):
    g = torch.Generator(device=cuda).manual_seed(F)
    x = torch.randn((37, F, d), generator=g, device=cuda)
    torch.testing.assert_close(dot_ops.dot_interaction(x),
                               dot_interaction_ref(x), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_inputs(cuda):
    p = LMAParams(d=D, m=M)
    sets = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        loc_ops.lma_locations(p, sets[:, ::2])           # not contiguous
    with pytest.raises(TypeError):
        loc_ops.lma_locations(p, sets.float())
    mem = _mem(cuda).requires_grad_()
    spec = fe.hashed_spec("hashed_elem", D, M, 1)
    gids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):                    # no backward yet
        fe.fused_lookup(spec, mem, gids)
