"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an sm_90 device and skip elsewhere.  They cover what the paths at
full width do not: sliding windows, the hashed schemes, ragged set widths,
empty sets, keys and seeds >= 2^31, bags, long duplicate runs, flat pools
at embedding widths below a warp (d = 10 and d = 1, xDeepFM's; d = 18,
DIN's; d = 16 striped, DCN-v2's), the dot
interaction's edge shapes, the weight gradient's order of sums, the CIN
layer at ragged shapes, the chunk kernels and the slab mode of the lookup
and scatter-add on every scheme, the scatter-add's cooperative grid (its
own zero fill of a reused NaN buffer, more values than it stages, few
rows, CUDA-graph capture, a refused launch), and that each autograd path
launches its kernels.  On the card, with no JAX
installed, run them as
``python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.allocation import LMAParams  # noqa: E402
from repro_torch.kernels.cin import kernel as ck  # noqa: E402
from repro_torch.kernels.cin import ops as cin_ops  # noqa: E402
from repro_torch.kernels.cin.ref import cin_ref  # noqa: E402
from kernel_schedules import bag_fma_chain, weight_grad_lanes  # noqa: E402
from repro_torch.kernels.dot_interaction import kernel as dk  # noqa: E402
from repro_torch.kernels.dot_interaction import ops as dot_ops  # noqa: E402
from repro_torch.kernels.dot_interaction.ref import \
    dot_interaction_ref  # noqa: E402
from repro_torch.kernels.fused_embed import ops as fe  # noqa: E402
from repro_torch.kernels.fused_embed import ref as fref  # noqa: E402
from repro_torch.kernels.lma_locations import ops as loc_ops  # noqa: E402
from repro_torch.kernels.lma_locations.ref import \
    lma_locations_ref  # noqa: E402
from repro_torch.kernels.fused_embed import kernel as fk  # noqa: E402
from repro_torch.kernels.sparse_update import kernel as sk  # noqa: E402
from repro_torch.kernels.sparse_update import ops as su  # noqa: E402
from repro_torch.kernels.sparse_update.ref import \
    sparse_adagrad_ref  # noqa: E402

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


@pytest.mark.parametrize("B,F,d,offset", [
    (1, 27, 64, 0),        # one sample
    (8451, 27, 64, 0),     # groups of 4 samples, the last one of 3
    (4099, 27, 64, 0),     # groups of 1 over a persistent grid
    (37, 2, 64, 0),        # one pair a sample
    (8450, 27, 7, 0),      # d % 4 != 0: scalar fragments, groups of 4
    (9, 100, 128, 0),      # a sample past the 48 KB static shared memory
    (333, 27, 64, 1),      # x not 16-byte aligned: scalar fragments
])
def test_dot_interaction_kernel_edge_shapes(cuda, B, F, d, offset):
    g = torch.Generator(device=cuda).manual_seed(B)
    buf = torch.randn(B * F * d + offset, generator=g, device=cuda)
    x = buf[offset:].view(B, F, d).mul_(d ** -0.5)   # keeps the offset
    before = dk.dot_interaction_cuda.launches
    got = dot_ops.dot_interaction(x)
    assert dk.dot_interaction_cuda.launches == before + 1
    torch.testing.assert_close(got, dot_interaction_ref(x), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got, dot_ops.dot_interaction(x))


def _lma_case(cuda, rng, n, striped, S=24, d=D):
    p = LMAParams(d=d, m=M, n_h=4, max_set=S, seed=0xF00D_0001,
                  striped=striped, min_support=3)
    sets = _sets(rng, n, S).to(cuda)
    support = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    gids = torch.from_numpy(
        rng.integers(2**31 - 5000, 2**31 - 1, n).astype(np.int32))
    assert (support < p.min_support).any()
    return fe.lma_spec(p), gids.to(cuda), sets, support.to(cuda)


@pytest.mark.parametrize("scheme", ["lma", "lma_striped", "hashed_elem",
                                    "hashed_row"])
def test_fused_locations_kernel_matches_plain(cuda, scheme):
    rng = np.random.default_rng(5)
    if scheme.startswith("lma"):
        spec, gids, sets, support = _lma_case(cuda, rng, 333,
                                              scheme == "lma_striped")
        extra = (sets, support)
    else:
        spec = fe.hashed_spec(scheme, D, M, 0x8765_4321)
        gids = torch.from_numpy(
            rng.integers(0, 2**31 - 1, 333).astype(np.int32)).to(cuda)
        extra = ()
    got = fe.fused_locations(spec, gids, *extra)
    assert torch.equal(got, fref.locations_ref(spec, gids, *extra))


@pytest.mark.parametrize("striped", [False, True])
def test_scatter_add_and_weight_grad_match_plain(cuda, striped):
    rng = np.random.default_rng(6)
    B, L = 40, 7
    spec, gids, sets, support = _lma_case(cuda, rng, B * L, striped)
    mem = _mem(cuda)
    g = torch.randn((B * L, D), device=cuda)
    got = fk.fused_scatter_add_cuda(spec, g, gids, sets, support)
    want = fref.scatter_add_ref(spec, g, gids, sets, support)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    gb = torch.randn((B, D), device=cuda)
    w = torch.rand((B, L), device=cuda)
    bag = (gids.reshape(B, L), sets.reshape(B, L, -1), support.reshape(B, L))
    got = fk.fused_scatter_add_cuda(spec, gb, *bag, weights=w)
    want = fref.scatter_add_ref(spec, gb, *bag, weights=w)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    got = fk.fused_weight_grad_cuda(spec, mem, gb, *bag)
    want = fref.weight_grad_ref(spec, mem, gb, *bag)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [D, 64])
@pytest.mark.parametrize("L", [1, 7])
@pytest.mark.parametrize("scheme", ["lma", "lma_striped", "hashed_elem",
                                    "hashed_row"])
def test_weight_grad_kernel_matches_lane_order(cuda, scheme, L, d):
    """The kernel's bits are those of its order of sums (emulated, every
    operation rounded alone), and within 1e-6 of the plain version; B is
    not a multiple of a block's 8 warps."""
    rng = np.random.default_rng(10 + L + d)
    B = 37
    if scheme.startswith("lma"):
        spec, gids, sets, support = _lma_case(
            cuda, rng, B * L, scheme == "lma_striped", d=d)
        flat = (gids, sets, support)
        bag = (gids.reshape(B, L), sets.reshape(B, L, -1),
               support.reshape(B, L))
    else:
        spec = fe.hashed_spec(scheme, d, M, 0x8765_4321)
        gids = torch.from_numpy(
            rng.integers(0, 2**31 - 1, B * L).astype(np.int32)).to(cuda)
        flat, bag = (gids,), (gids.reshape(B, L),)
    mem = _mem(cuda) * 0.1
    g = torch.randn((B, d), device=cuda)
    got = fk.fused_weight_grad_cuda(spec, mem, g, *bag)
    e = mem[fref.locations_ref(spec, *flat).long()].reshape(B, L, d)
    assert torch.equal(got, weight_grad_lanes(e, g))
    torch.testing.assert_close(got, fref.weight_grad_ref(spec, mem, g, *bag),
                               rtol=1e-6, atol=1e-6)


def _stream(rng, unique, m=M):
    if unique:
        live = np.sort(rng.choice(m, 900, replace=False)).astype(np.int32)
        idx = np.concatenate([live, np.full(124, m, np.int32)])
        vals = rng.normal(0, 1, idx.shape[0]).astype(np.float32)
        vals[live.shape[0]:] = 0.0
        return idx, vals
    slots = np.sort(rng.choice(m, 700, replace=False))
    runs = rng.geometric(0.05, slots.shape[0])          # runs of ~20, some > 32
    runs[:3] = (1 << 15, 256 * 3, 33)                   # round edges too
    idx = np.repeat(slots, runs).astype(np.int32)
    vals = (rng.normal(0, 1, idx.shape[0])
            * 10.0 ** rng.uniform(-6, 0, idx.shape[0])).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("unique", [True, False])
def test_sparse_adagrad_kernel_matches_plain(cuda, unique):
    """The kernel sums each run in fold_duplicates' order and rounds every
    operation alone, so updates and accumulators are equal, not close."""
    rng = np.random.default_rng(7)
    idx, vals = _stream(rng, unique)
    idx, vals = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    acc0 = torch.rand(M, device=cuda) * 0.25
    acc0[::2] = 0.0
    acc_k, acc_p = acc0.clone(), acc0.clone()
    u_k, _ = su.sparse_update("adagrad", idx, vals, (acc_k,), unique=unique,
                              lr=0.01, eps=1e-10)
    u_p, _ = sparse_adagrad_ref(idx, vals, acc_p, lr=0.01, eps=1e-10,
                                unique=unique)
    assert torch.equal(u_k, u_p)
    assert torch.equal(acc_k, acc_p)
    touched = torch.zeros(M, dtype=torch.bool, device=cuda)
    touched[idx[idx < M].long()] = True
    assert torch.equal(acc_k[~touched].view(torch.int32),
                       acc0[~touched].view(torch.int32))


def test_autograd_paths_launch_the_kernels(cuda):
    from repro_torch.optim import sparse as sp
    from repro_torch.optim.optimizers import adagrad, apply_updates

    rng = np.random.default_rng(8)
    B, L = 16, 5
    spec, gids, sets, support = _lma_case(cuda, rng, B * L, True)
    mem = _mem(cuda).requires_grad_()
    counts = [fk.fused_lookup_cuda, fk.fused_scatter_add_cuda,
              fk.fused_weight_grad_cuda, fk.fused_locations_cuda,
              sk.sparse_adagrad_cuda]
    before = [k.launches for k in counts]
    fe.fused_lookup(spec, mem, gids, sets, support).sum().backward()
    assert mem.grad is not None
    w = torch.rand((B, L), device=cuda, requires_grad=True)
    fe.fused_embed_bag(spec, mem, gids.reshape(B, L), w,
                       sets.reshape(B, L, -1),
                       support.reshape(B, L)).sum().backward()
    assert w.grad is not None
    mem.grad = None
    with sp.capture() as cap:
        cap.lookup(mem, lambda: fe.fused_lookup(spec, mem, gids, sets,
                                                support),
                   lambda: fe.fused_locations(spec, gids, sets, support),
                   D).pow(2).sum().backward()
    assert mem.grad is None
    grads = cap.grads({"memory": mem})
    opt = adagrad(0.1)
    state = opt.init({"memory": mem})
    updates, state = opt.update(grads, state, {"memory": mem})
    apply_updates({"memory": mem}, updates)
    launched = [k.launches - b for k, b in zip(counts, before)]
    assert launched == [3, 2, 1, 1, 1]


def test_wrappers_reject_bad_inputs(cuda):
    p = LMAParams(d=D, m=M)
    sets = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        loc_ops.lma_locations(p, sets[:, ::2])           # not contiguous
    with pytest.raises(TypeError):
        loc_ops.lma_locations(p, sets.float())
    spec = fe.hashed_spec("hashed_elem", D, M, 1)
    gids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fk.fused_locations_cuda(spec, gids.long())
    with pytest.raises(ValueError):                      # not on the card
        fk.fused_locations_cuda(spec, gids.cpu())
    with pytest.raises(ValueError):                      # g [N, d] expected
        fk.fused_scatter_add_cuda(spec, torch.zeros((4, D + 1), device=cuda),
                                  gids)
    acc = torch.zeros(M, device=cuda)
    with pytest.raises(TypeError):
        sk.sparse_adagrad_cuda(gids.long(), torch.zeros(4, device=cuda), acc,
                               lr=0.1)
    with pytest.raises(ValueError):
        sk.sparse_adagrad_cuda(gids, torch.zeros(4), acc, lr=0.1)
    mem = _mem(cuda).requires_grad_()                    # gradients work now
    out = fe.fused_lookup(spec, mem, gids)
    assert out.requires_grad


@pytest.mark.parametrize("d", [10, 1])
def test_flat_lookup_and_locations_below_a_warp(cuda, d):
    """xDeepFM's pools: flat (m % d != 0 for d = 10), lanes >= d idle."""
    rng = np.random.default_rng(20 + d)
    m = 21_102_592 if d == 10 else 2_113_536
    p = LMAParams(d=d, m=m, n_h=4, max_set=32, seed=0, min_support=2)
    assert p.stripe == 0
    spec = fe.lma_spec(p)
    n = 777
    sets = _sets(rng, n, 32).to(cuda)
    support = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32)).to(cuda)
    gids = torch.from_numpy(
        rng.integers(0, 33_763_877, n).astype(np.int32)).to(cuda)
    mem = _mem(cuda, m)
    assert torch.equal(fe.fused_lookup(spec, mem, gids, sets, support),
                       fref.fused_lookup_ref(spec, mem, gids, sets, support))
    assert torch.equal(fe.fused_locations(spec, gids, sets, support),
                       fref.locations_ref(spec, gids, sets, support))


@pytest.mark.parametrize("d,m,n_gids", [(18, 5_627_904, 5_000_000),
                                         (16, 33_763_328, 33_762_577)])
def test_lookup_locations_scatter_at_din_and_dcn_widths(cuda, d, m, n_gids):
    """DIN's pool (d = 18, 5,627,904 slots: flat, 5,627,904 % 18 = 6) and
    DCN-v2's (d = 16, striped, 2,110,208 a stripe): the lookup and the
    locations bit-exact, flat and bag lookups through the fused kernel;
    the scatter-add within 1e-6 of each slot's sum |g|, with hot ids
    repeated so slots collect long runs."""
    rng = np.random.default_rng(d)
    p = LMAParams(d=d, m=m, n_h=4, max_set=32, seed=0, min_support=2,
                  striped=m % d == 0)
    assert (p.stripe > 0) == (d == 16)
    spec = fe.lma_spec(p)
    n = 4096
    sets = _sets(rng, n, 32).to(cuda)
    support = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32)).to(cuda)
    ids = rng.integers(0, n_gids, n).astype(np.int32)
    ids[: n // 2] = ids[: 64].repeat(32)           # 64 ids, 32 times each
    sets[: n // 2] = sets[:64].repeat(32, 1)
    support[: n // 2] = support[:64].repeat(32)
    gids = torch.from_numpy(ids).to(cuda)
    mem = _mem(cuda, m)
    assert torch.equal(fe.fused_lookup(spec, mem, gids, sets, support),
                       fref.fused_lookup_ref(spec, mem, gids, sets, support))
    loc = fe.fused_locations(spec, gids, sets, support)
    assert torch.equal(loc, fref.locations_ref(spec, gids, sets, support))
    B, L = 64, 64
    w = torch.rand((B, L), device=cuda)
    ids_b, sets_b, support_b = (gids.reshape(B, L), sets.reshape(B, L, -1),
                                support.reshape(B, L))
    bag = fe.fused_embed_bag(spec, mem, ids_b, w, sets_b, support_b)
    want = fref.fused_embed_bag_ref(spec, mem, ids_b, w, sets_b, support_b)
    abs_bag = fref.fused_embed_bag_ref(spec, mem.abs(), ids_b, w, sets_b,
                                       support_b)          # sum |w M|
    assert bool(((bag - want).abs() <= 1e-6 * abs_bag).all())
    g = torch.randn((n, d), device=cuda)
    got = fk.fused_scatter_add_cuda(spec, g, gids, sets, support)
    want = fref.scatter_add_ref(spec, g, gids, sets, support)
    abs_sum = torch.zeros(m, device=cuda).index_add_(
        0, loc.reshape(-1).long(), g.abs().reshape(-1))
    assert bool(((got - want).abs() <= 1e-6 * abs_sum).all())


def _cin_inputs(cuda, B, Hk, F, d, Ho, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xk = torch.randn((B, Hk, d), generator=g, device=cuda)
    x0 = torch.randn((B, F, d), generator=g, device=cuda)
    w = torch.randn((Ho, Hk, F), generator=g, device=cuda) / (Hk * F) ** 0.5
    return xk, x0, w


# xDeepFM's three layers at a ragged batch, the smoke shapes, F below the
# kernel's chunk depth, d = 1, and channel counts off the kernel's tile
@pytest.mark.parametrize("B,Hk,F,d,Ho", [
    (333, 39, 39, 10, 200), (37, 200, 39, 10, 200), (64, 24, 12, 8, 24),
    (16, 8, 8, 4, 16), (5, 13, 5, 3, 113), (70, 7, 40, 1, 1),
    (50, 1, 1, 10, 200), (3, 1, 1, 1, 7), (2000, 8, 5, 10, 200),
    (1000, 13, 7, 40, 201), (3500, 39, 39, 10, 200), (4001, 3, 2, 1, 9)])
def test_cin_kernel_matches_plain(cuda, B, Hk, F, d, Ho):
    """Within 1e-5 of each output's sum |terms| (float32 sums in another
    order)."""
    xk, x0, w = _cin_inputs(cuda, B, Hk, F, d, Ho, B)
    got = ck.cin_cuda(xk, x0, w)
    want = cin_ref(xk, x0, w)
    scale = torch.einsum("bhd,bfd,ohf->bod", xk.abs().double(),
                         x0.abs().double(), w.abs().double())
    assert got.shape == (B, Ho, d)
    assert float(((got - want).abs() / scale.clamp_min(1e-30)).max()) <= 1e-5


def test_cin_kernel_gives_the_same_bits_twice(cuda):
    """No atomics and no split K: the same inputs give the same bits (the
    trainer's check_step compares two forwards bit for bit)."""
    for B in (512, 4096):
        xk, x0, w = _cin_inputs(cuda, B, 200, 39, 10, 200, B)
        a, b = ck.cin_cuda(xk, x0, w), ck.cin_cuda(xk, x0, w)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cin_autograd_launches_the_kernel(cuda):
    """Forward on the card is one kernel launch; the plain backward gives
    the CPU path's gradients."""
    xk, x0, w = _cin_inputs(cuda, 9, 6, 5, 4, 7, 1)
    g = torch.randn((9, 7, 4), device=cuda)
    before = ck.cin_cuda.launches
    leaves = [t.clone().requires_grad_() for t in (xk, x0, w)]
    cin_ops.cin(*leaves).backward(g)
    assert ck.cin_cuda.launches == before + 1
    cpu = [t.cpu().requires_grad_() for t in (xk, x0, w)]
    cin_ops.cin(*cpu).backward(g.cpu())
    for a, b in zip(leaves, cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-5,
                                   atol=1e-5)


def test_cin_wrapper_rejects_bad_inputs(cuda):
    xk, x0, w = _cin_inputs(cuda, 4, 6, 5, 4, 7, 2)
    with pytest.raises(ValueError):                      # not contiguous
        ck.cin_cuda(xk.transpose(1, 2), x0, w)
    with pytest.raises(TypeError):
        ck.cin_cuda(xk.double(), x0, w)
    with pytest.raises(ValueError):                      # w not [Ho, Hk, F]
        ck.cin_cuda(xk, x0, w[:, :, :4].contiguous())
    with pytest.raises(ValueError):                      # not on the card
        ck.cin_cuda(xk.cpu(), x0, w)


# ------------------------------------ rows 8, 9 (sparse SGD / Adam), 13 (bag)

def _row_stream(rng, unique, rows, d):
    """The row layout: one index per row, values [K, d]; bucketed streams
    carry runs up to 40 (a warp folds a run per column)."""
    if unique:
        live = np.sort(rng.choice(rows, 300, replace=False)).astype(np.int32)
        idx = np.concatenate([live, np.full(37, rows, np.int32)])
    else:
        slots = np.sort(rng.choice(rows, 200, replace=False))
        runs = rng.geometric(0.2, slots.shape[0])
        runs[:2] = (40, 33)
        idx = np.repeat(slots, runs).astype(np.int32)
    vals = (rng.normal(0, 1, (idx.shape[0], d))
            * 10.0 ** rng.uniform(-6, 0, (idx.shape[0], 1))).astype(np.float32)
    vals[idx >= rows] = 0.0
    return idx, vals


def _states(cuda, algo, shape, rowwise=False):
    g = torch.Generator(device=cuda).manual_seed(3)
    if algo == "sgd":
        return (torch.randn(shape, generator=g, device=cuda),)
    if algo == "adagrad":
        return (torch.rand(shape, generator=g, device=cuda),)
    nu_shape = shape[:1] if rowwise else shape
    return (torch.randn(shape, generator=g, device=cuda) * 1e-3,
            torch.rand(nu_shape, generator=g, device=cuda) * 1e-6)


_HYPER = {"sgd": dict(lr=0.01, momentum=0.9),
          "adagrad": dict(lr=0.01, eps=1e-10),
          "adam": dict(lr=0.01, b1=0.9, b2=0.999, bc1=0.271, bc2=0.00299,
                       eps=1e-8)}


def _bits_equal(a, b):
    """Equal as values and as int32 bit patterns (-0 is not +0)."""
    return torch.equal(a, b) and torch.equal(a.view(torch.int32),
                                             b.view(torch.int32))


def _check_update(cuda, algo, idx, vals, states, unique):
    """Kernel vs plain version on copies of the states: updates and states
    bit-equal, compared as int32 bit patterns too, so a -0 against a +0
    fails (the kernel keeps the plain version's row mean order for a
    row-wise nu), untouched slots bit-unchanged."""
    from repro_torch.kernels.sparse_update import ref as sref
    idx, vals = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    mine = tuple(s.clone() for s in states)
    plain = tuple(s.clone() for s in states)
    u_k, _ = su.sparse_update(algo, idx, vals, mine, unique=unique,
                              **_HYPER[algo])
    u_p, _ = getattr(sref, f"sparse_{algo}_ref")(idx, vals, *plain,
                                                 unique=unique,
                                                 **_HYPER[algo])
    assert _bits_equal(u_k, u_p)
    lead = states[0].shape[0]
    touched = torch.zeros(lead, dtype=torch.bool, device=cuda)
    touched[idx[idx < lead].long()] = True
    for s0, k, p in zip(states, mine, plain):
        assert _bits_equal(k, p)
        assert torch.equal(k[~touched].view(torch.int32),
                           s0[~touched].view(torch.int32))


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("algo", ["sgd", "adam"])
def test_sparse_sgd_adam_flat_match_plain(cuda, algo, unique):
    """Flat [m] states: runs up to 2^15 (the warp pass) and sentinel tails."""
    idx, vals = _stream(np.random.default_rng(9), unique)
    _check_update(cuda, algo, idx, vals, _states(cuda, algo, (M,)), unique)


def _tile_edge_stream(rng, tile=2048, halo=2048):
    """Runs of every length 1..tile + halo + 1 in random order (so run ends
    fall on and around every tile edge), one of 2^15, then a sentinel tail;
    values of both signs and many scales, some -0."""
    lengths = np.concatenate([np.arange(1, tile + halo + 2), [1 << 15]])
    rng.shuffle(lengths)
    m = 2 * lengths.shape[0] + 1
    idx = np.concatenate([np.repeat(np.arange(lengths.shape[0]) * 2, lengths),
                          np.full(777, m)]).astype(np.int32)
    vals = (rng.normal(0, 1, idx.shape[0])
            * 10.0 ** rng.uniform(-6, 1, idx.shape[0])).astype(np.float32)
    vals[rng.random(idx.shape[0]) < 0.01] = -0.0
    return idx, vals, m


@pytest.mark.parametrize("algo", ["adagrad", "sgd", "adam"])
def test_flat_fold_at_tile_edges_matches_plain(cuda, algo):
    """The flat fold's tiles, halo and pass 2 against the plain versions,
    bit for bit, on runs that end on every tile edge and cover the halo."""
    idx, vals, m = _tile_edge_stream(np.random.default_rng(11))
    _check_update(cuda, algo, idx, vals, _states(cuda, algo, (m,)), False)


def _row_edge_stream(rng, kind, rows, d):
    """Bucketed row streams against the row kernel's 32-entry spans:
    ``negzero`` runs of 1..70 with 1% -0 values, lone all -0 entries and a
    column -0 through whole runs (the reference folds each such sum to
    +0); ``span_edges`` runs of every length 1..97 in random order, so
    runs start and end at every offset of a span and cross its edges;
    ``long_run`` one run of 5,000 (past the kernel's registers, into its
    shared carry) among short ones.  All end in a sentinel tail."""
    if kind == "long_run":
        lengths = np.concatenate([rng.integers(1, 40, 30), [5000],
                                  rng.integers(1, 40, 30)])
    else:
        lengths = rng.permutation(np.arange(1, 71 if kind == "negzero"
                                            else 98))
    slots = np.sort(rng.choice(rows, lengths.shape[0], replace=False))
    idx = np.concatenate([np.repeat(slots, lengths),
                          np.full(45, rows)]).astype(np.int32)
    vals = (rng.normal(0, 1, (idx.shape[0], d))
            * 10.0 ** rng.uniform(-6, 1, (idx.shape[0], 1))).astype(np.float32)
    if kind == "negzero":
        vals[rng.random(vals.shape) < 0.01] = -0.0
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        vals[starts[lengths == 1]] = -0.0
        for r in range(0, lengths.shape[0], 3):
            vals[starts[r]:starts[r] + lengths[r], rng.integers(d)] = -0.0
    vals[idx >= rows] = 0.0
    return idx, vals


@pytest.mark.parametrize("stream,unique", [
    ("random", True), ("random", False), ("negzero", False),
    ("span_edges", False), ("long_run", False)])
@pytest.mark.parametrize("algo,rowwise", [("sgd", False), ("adagrad", False),
                                          ("adam", False), ("adam", True)])
@pytest.mark.parametrize("d", [64, 8, 100])
def test_sparse_update_row_layout_matches_plain(cuda, algo, rowwise, unique,
                                                d, stream):
    """[rows, d] states with [K, d] values (the row-mode SparseGrad), at
    dlrm-rm2's d = 64, below a warp and off a power of two; Adam's row-wise
    nu too.  ``random``: short runs or a sentinel-padded unique stream; the
    bucketed edge streams (``_row_edge_stream``) start from states with a
    tenth of their elements -0, so a run sum the kernel leaves -0 where the
    plain version folds it to +0 shows in every op's update."""
    rows = 1024
    if stream == "random":
        idx, vals = _row_stream(np.random.default_rng(d), unique, rows, d)
        states = _states(cuda, algo, (rows, d), rowwise)
    else:
        idx, vals = _row_edge_stream(np.random.default_rng(d + 1), stream,
                                     rows, d)
        states = _states(cuda, algo, (rows, d), rowwise)
        g = torch.Generator(device=cuda).manual_seed(d)
        for x in states:
            x[torch.rand(x.shape, generator=g, device=cuda) < 0.1] = -0.0
    _check_update(cuda, algo, idx, vals, states, unique)


def test_optimizers_launch_sgd_and_adam(cuda):
    """sparse_sgd and sparse_rowwise_adam on a SparseGrad launch their
    kernels once a step, lazily: untouched parameters keep their bits."""
    from repro_torch.optim import sparse as sp
    from repro_torch.optim.optimizers import apply_updates

    rng = np.random.default_rng(12)
    for opt, kernel in ((sp.sparse_sgd(0.1, 0.9), sk.sparse_sgd_cuda),
                        (sp.sparse_rowwise_adam(0.1), sk.sparse_adam_cuda)):
        mem = _mem(cuda)
        p0 = mem.clone()
        state = opt.init({"memory": mem})
        before = kernel.launches
        loc = torch.from_numpy(rng.integers(0, M // 4, 500).astype(np.int32))
        for _ in range(3):
            g = sp.from_locations(loc.to(cuda), torch.randn(500, device=cuda),
                                  (M,))
            updates, state = opt.update({"memory": g}, state, {"memory": mem})
            apply_updates({"memory": mem}, updates)
        assert kernel.launches == before + 3
        assert torch.equal(mem[M // 4:], p0[M // 4:])


@pytest.mark.parametrize("B,L,V,d", [(2048, 32, 65_536, 64), (333, 26, 5000, 64),
                                     (130, 7, 300, 10), (5, 40, 100, 256),
                                     (64, 0, 10, 8)])
def test_embedding_bag_kernel_matches_plain(cuda, B, L, V, d):
    """Within 1e-6 of each output's sum_l |w T| (float32 sums in another
    order); B off 128, L past a warp, d below a warp and at its limit."""
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    g = torch.Generator(device=cuda).manual_seed(B)
    table = torch.randn((V, d), generator=g, device=cuda)
    ids = torch.randint(0, V, (B, L), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((B, L), generator=g, device=cuda) - 0.5
    before = ek.embedding_bag_cuda.launches
    got = eb.embedding_bag(table, ids, w)
    assert ek.embedding_bag_cuda.launches == before + 1
    want = embedding_bag_ref(table, ids, w)
    scale = torch.einsum("bl,bld->bd", w.abs().double(),
                         table[ids.long()].abs().double())
    assert got.shape == (B, d)
    assert float(((got - want).abs() / scale.clamp_min(1e-30)).max()) <= 1e-6
    with pytest.raises(ValueError):                      # not on the card
        ek.embedding_bag_cuda(table, ids.cpu(), w)


@pytest.mark.parametrize("d", [10, 100, 64, 256])
@pytest.mark.parametrize("L", [1, 33])
def test_embedding_bag_kernel_matches_fma_chain(cuda, d, L):
    """The bag kernel's bits against its stated order of sums
    (``kernel_schedules.bag_fma_chain``: each column an fmaf chain in l
    order), the same bits twice: d = 10 takes scalar units, d = 100 float4s
    on 25 of a warp's lanes, d = 64 a half-warp, d = 256 two float4s a
    lane; also a table view off 16-byte alignment (scalar units); ids
    outside [0, V) add nothing."""
    from repro_torch.kernels.embedding_bag import kernel as ek

    B, V = 333, 5000
    g = torch.Generator(device=cuda).manual_seed(d + L)
    table = torch.randn((V, d), generator=g, device=cuda)
    ids = torch.randint(0, V, (B, L), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[3, 0], ids[5, L - 1] = -1, V
    w = torch.rand((B, L), generator=g, device=cuda) - 0.5
    got = ek.embedding_bag_cuda(table, ids, w)
    again = ek.embedding_bag_cuda(table, ids, w)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.view(torch.int32),
                       bag_fma_chain(table, ids, w).view(torch.int32))
    off = torch.randn(V * d + 1, generator=g, device=cuda)[1:].view(V, d)
    assert torch.equal(ek.embedding_bag_cuda(off, ids, w).view(torch.int32),
                       bag_fma_chain(off, ids, w).view(torch.int32))


def test_subnormal_moments_match_plain(cuda):
    """A gradient of 3e-20 gives Adam a subnormal second moment (about
    9e-43): kernel and plain version both keep it (PyTorch's index_add_
    on the card, an atomic add, would flush it to zero)."""
    from repro_torch.kernels.sparse_update import ref as sref
    idx = torch.arange(0, 64, 2, dtype=torch.int32, device=cuda)
    vals = torch.full((32,), 3e-20, device=cuda)
    mine = (torch.zeros(M, device=cuda), torch.zeros(M, device=cuda))
    plain = (torch.zeros(M, device=cuda), torch.zeros(M, device=cuda))
    u_k, _ = su.sparse_update("adam", idx, vals, mine, **_HYPER["adam"])
    u_p, _ = sref.sparse_adam_ref(idx, vals, *plain, **_HYPER["adam"])
    nu = mine[1][idx.long()]
    assert bool((nu > 0).all()) and bool((nu < 1.17e-38).all())
    assert torch.equal(u_k, u_p)
    for a, b in zip(mine, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# --------------------------------------------- the chunked exchange (10-12)

def _slab_case(cuda, scheme, rank, P=4, n=333):
    """(spec, the whole pool, gids, extra inputs, base, m_local) for one
    rank's slab of a P-way split."""
    rng = np.random.default_rng(10 + rank)
    if scheme.startswith("lma"):
        spec, gids, sets, support = _lma_case(cuda, rng, n,
                                              scheme == "lma_striped")
        extra = (sets, support)
    else:
        spec = fe.hashed_spec(scheme, D, M, 0x8765_4321)
        gids = torch.from_numpy(
            rng.integers(0, 2**31 - 1, n).astype(np.int32)).to(cuda)
        extra = ()
    return spec, _mem(cuda), gids, extra, rank * (M // P), M // P


def _held_to_sum_abs(got, want, loc, g, base, m_local):
    """Per slot within 1e-6 of its sum |g| (atomics add in any order)."""
    rel = loc.reshape(-1).long() - base
    inb = (rel >= 0) & (rel < m_local)
    abs_sum = torch.zeros(m_local, dtype=torch.float64, device=g.device)
    abs_sum.index_add_(0, rel[inb], g.reshape(-1)[inb].abs().double())
    assert bool(((got - want).abs().double() <= 1e-6 * abs_sum).all())


SLAB_SCHEMES = ["lma", "lma_striped", "hashed_elem", "hashed_row"]


@pytest.mark.parametrize("rank", [0, 3])
@pytest.mark.parametrize("scheme", SLAB_SCHEMES)
def test_chunk_kernels_match_plain(cuda, scheme, rank):
    """Rows 10 and 11 bit-exact, row 12 within 1e-6 of sum |g|."""
    spec, mem, gids, extra, base, m_local = _slab_case(cuda, scheme, rank)
    slab = mem[base:base + m_local].contiguous()
    part, loc = fk.fused_chunk_lookup_cuda(spec, slab, gids, *extra,
                                           base=base)
    want_part, want_loc = fref.chunk_lookup_ref(spec, slab, gids, *extra,
                                                base=base)
    assert torch.equal(loc, want_loc) and torch.equal(part, want_part)
    inb = (loc >= base) & (loc < base + m_local)
    assert inb.any() and (~inb).any()
    got = fk.fused_chunk_gather_cuda(slab, loc, base)
    assert torch.equal(got, fref.chunk_gather_ref(slab, loc, base))
    g = torch.randn(loc.shape, device=cuda)
    dm = fk.fused_chunk_scatter_cuda(loc, g, base, m_local)
    _held_to_sum_abs(dm, fref.chunk_scatter_ref(loc, g, base, m_local), loc,
                     g, base, m_local)


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("scheme", SLAB_SCHEMES)
def test_slab_mode_lookup_and_scatter_add_match_plain(cuda, scheme, rank):
    """Rows 2 and 5 with ``base``: the lookup bit-exact, the scatter-add
    within 1e-6 of sum |g| of the whole pool's gradient cut to the slab."""
    spec, mem, gids, extra, base, m_local = _slab_case(cuda, scheme, rank)
    slab = mem[base:base + m_local].contiguous()
    got = fk.fused_lookup_cuda(spec, slab, gids, *extra, base=base)
    assert torch.equal(got, fref.fused_lookup_ref(spec, slab, gids, *extra,
                                                  base=base))
    g = torch.randn((gids.numel(), D), device=cuda)
    dm = fk.fused_scatter_add_cuda(spec, g, gids, *extra, base=base,
                                   m_local=m_local)
    loc = fref.locations_ref(spec, gids, *extra)
    _held_to_sum_abs(dm, fref.scatter_add_ref(spec, g, gids, *extra, base=base,
                                              m_local=m_local),
                     loc, g, base, m_local)


def test_chunk_autograd_launches_the_kernels(cuda):
    spec, mem, gids, extra, base, m_local = _slab_case(cuda, "lma", 1)
    slab = mem[base:base + m_local].contiguous().requires_grad_()
    counts = [fk.fused_chunk_lookup_cuda, fk.fused_chunk_gather_cuda,
              fk.fused_chunk_scatter_cuda]
    before = [k.launches for k in counts]
    part, loc = fe.fused_chunk_lookup(spec, slab, gids, *extra, base=base)
    (part + fe.fused_chunk_gather(slab, loc, base)).sum().backward()
    assert slab.grad is not None and slab.grad.shape == (m_local,)
    assert [k.launches - b for k, b in zip(counts, before)] == [1, 1, 2]


def test_chunk_wrappers_reject_bad_inputs(cuda):
    spec = fe.hashed_spec("hashed_elem", D, M, 1)
    gids = torch.zeros(4, dtype=torch.int32, device=cuda)
    slab = torch.zeros(M // 4, device=cuda)
    with pytest.raises(ValueError):          # the slab overruns the pool
        fk.fused_chunk_lookup_cuda(spec, slab, gids, base=M - 10)
    with pytest.raises(ValueError):          # a slab with no base
        fk.fused_lookup_cuda(spec, slab, gids)
    loc = torch.zeros((4, D), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fk.fused_chunk_gather_cuda(slab, loc.long())
    with pytest.raises(ValueError):
        fk.fused_chunk_scatter_cuda(loc, torch.zeros((4, D + 1), device=cuda),
                                    0, M // 4)


# ------------------------------------------------------------- durability

def _card_pool_trainer(cuda, steps, faults=None):
    """A striped LMA pool read through the fused kernel, sparse Adagrad."""
    from repro_torch.core.signatures import synthetic_dense_store
    from repro_torch.embed import EmbeddingTable, get_scheme
    from repro_torch.optim.optimizers import adagrad
    from repro_torch.resilience.faults import FaultInjector
    from repro_torch.train.trainer import Trainer, TrainerConfig

    table = EmbeddingTable(get_scheme("lma").build_config((512,), D, 32768,
                                                          seed=3))
    bufs = table.make_buffers(synthetic_dense_store(512, 64, max_set=16,
                                                    seed=2, device=cuda))
    Y = np.random.default_rng(1).normal(size=(512, D)).astype(np.float32)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = torch.nn.ParameterDict(table.init(
                torch.Generator(device=cuda).manual_seed(0), device=cuda))

    def batch_fn(step):
        ids = np.random.default_rng(step).integers(0, 512, (64,), np.int32)
        return {"ids": ids, "y": Y[ids]}

    def loss_fn(model, b):
        e = table.embed(dict(model.embedding), bufs, 0, b["ids"])
        return torch.mean((e - b["y"]) ** 2), {}

    return Trainer(TrainerConfig(total_steps=steps, log_every=0), loss_fn,
                   Model(), adagrad(0.1), batch_fn, sparse_grads=True,
                   device=cuda,
                   faults=FaultInjector(faults) if faults else None)


@pytest.mark.parametrize("fault", ["nan_grad", "inf_grad", "huge_grad"])
def test_guarded_skip_is_bit_unchanged_on_the_card(cuda, fault):
    """A poisoned step on the card launches the lookup and the locations
    kernel (the forward and backward ran) but not sparse Adagrad, and leaves
    the pool and its accumulator bit-unchanged."""
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience.chaos import (durable_state,
                                              states_bit_identical)

    clean = _card_pool_trainer(cuda, 3)
    clean.fit(log=lambda _: None)
    faulted = _card_pool_trainer(cuda, 3, f"{fault}@3")
    faulted.fit(log=lambda _: None)
    before = durable_state(faulted)
    kernels = (fk.fused_lookup_cuda, fk.fused_locations_cuda,
               sk.sparse_adagrad_cuda)
    for k in kernels:
        k.launches = 0
    faulted.cfg.total_steps = 4
    out = faulted.fit(log=lambda _: None)
    flt.install(None)
    assert out["skipped_steps"] == 1 and out["nonfinite_grads"] == 1
    assert [k.launches for k in kernels] == [1, 1, 0]
    assert states_bit_identical(durable_state(faulted), before)
    assert states_bit_identical(before, durable_state(clean))


@pytest.mark.parametrize("n", [3 * 8192, 2 * 8192 + 17])
def test_card_checksums_and_scan_equal_numpy(cuda, n):
    from repro_torch.resilience import integrity as integ

    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=g, device=cuda)
    x[5] = float("inf")
    x[n - 1] = 3e38
    host = x.cpu().numpy()
    np.testing.assert_array_equal(
        integ.chunk_checksums(x).cpu().numpy().astype(np.uint32),
        integ.np_chunk_checksums(host))
    np.testing.assert_array_equal(integ.bad_value_chunks(x).cpu().numpy(),
                                  integ.np_bad_value_chunks(host))
    _, n_bad = integ.sanitize(x)
    want, want_n = integ.np_sanitize(host)
    assert n_bad == want_n == 2
    np.testing.assert_array_equal(x.cpu().numpy(), want)


# ------------------------------------------------------------------ tiering

def _tier_pair(cuda, m=64 * 1024, block=512, hot=16 * 512, stage=40):
    from repro_torch.tier import TieredStore

    mem = np.random.default_rng(m).normal(size=m).astype(np.float32)
    return mem, (TieredStore(mem, hot, block=block, stage_blocks=stage,
                             device=cuda),
                 TieredStore(mem, hot, block=block, stage_blocks=stage,
                             device="cpu"))


def test_tier_stage_round_trip_bit_exact_on_the_card(cuda):
    """Stage (pinned buffers, side stream), install, an edit of every live
    row, write-back and re-tier on the card hold the bits of the same
    protocol run by a CPU store, over both host buffers, with an optimizer
    moment leaf."""
    mem, (card, host) = _tier_pair(cuda)
    trees = {st: {"memory": st.initial_compact(),
                  "opt:acc": torch.full((st.compact_slots,), 0.5,
                                        device=st.device)}
             for st in (card, host)}
    rng = np.random.default_rng(1)
    for rnd in range(5):
        blocks = np.unique(rng.integers(0, card.n_blocks, 60))
        blocks = blocks[:card.stage_blocks]
        delta = rng.normal(size=card.compact_slots).astype(np.float32)
        for st, tree in trees.items():
            st.writeback(tree)
            if rnd == 3:
                st.observe(blocks, np.full(blocks.size, 100))
                st.retier(tree)
            st.stage(blocks)
            st.install(tree)
            with torch.no_grad():
                for leaf in tree.values():
                    leaf += torch.from_numpy(delta).to(leaf.device)
        for name in ("memory", "opt:acc"):
            a = card.full_pool(trees[card][name], name)
            b = host.full_pool(trees[host][name], name)
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert card.stats == host.stats and card.stats["promoted"] > 0


def test_tier_install_waits_for_the_staging_copy(cuda):
    """The staging copy runs on the store's side stream: with that stream
    held up by a sleep, install (on the current stream) still reads the
    staged rows, and three stages in a row (both pinned buffers refilled)
    each install their own rows."""
    mem, (card, _) = _tier_pair(cuda)
    tree = {"memory": card.initial_compact()}
    rows = mem.reshape(card.n_blocks, card.block)
    for blocks in ([20, 21, 22], [40, 41], [60, 61, 62, 63]):
        card.writeback(tree)
        with torch.cuda.stream(card._stream):
            torch.cuda._sleep(50_000_000)
        card.stage(np.asarray(blocks))
        card.install(tree)
        got = tree["memory"][card.hot_slots:card.hot_slots
                             + len(blocks) * card.block].cpu().numpy()
        np.testing.assert_array_equal(got, rows[blocks].reshape(-1))


# ------------------------------------------- the rest of distribution

def _ranks_on(device, fn, *args, data=1):
    from repro_torch.dist.collectives import run_ranks
    return run_ranks(fn, 4, *args, data=data, device=device)


def test_data_axis_sparse_adagrad_step_on_the_card(cuda):
    """A (data=2, model=2) sparse Adagrad step (lma striped, hashed_row,
    hashed_elem; psum and all_to_all) by 4 gloo ranks on cuda:0 (the
    lookup and update kernels) against the same step by 4 ranks on the
    CPU (their plain versions): losses and every slab within 1e-6."""
    import dist_ranks as dr
    runs = [(n, "adagrad", s) for n in ("lma", "hashed_row", "hashed_elem")
            for s in ("psum", "all_to_all")]
    card = _ranks_on("cuda:0", dr.card_step, runs, 2, data=2)
    host = _ranks_on("cpu", dr.card_step, runs, 2, data=2)
    for a, b in zip(card, host):
        for run in runs:
            np.testing.assert_allclose(a[run][0], b[run][0], rtol=1e-6)
            np.testing.assert_allclose(a[run][1], b[run][1], rtol=1e-6,
                                       atol=1e-6)


def test_csr_sharded_set_lookup_on_the_card(cuda):
    """The CSR store sharded over (1, 4) ranks on cuda:0: the set rows,
    masks and supports under every strategy bit-equal to the CPU ranks',
    and the LMA lookups through it (the chunk kernels) bit-equal too."""
    import dist_ranks as dr
    c, csr = dr.case("lma", seed=41), dr.csr_arrays()
    card = _ranks_on("cuda:0", dr.csr_lookups, c, csr)
    host = _ranks_on("cpu", dr.csr_lookups, c, csr)
    for a, b in zip(card, host):
        assert a["keys"] == b["keys"]
        for s in dr.STRATEGIES:
            for x, y in zip(a[(s, "sets")], b[(s, "sets")]):
                np.testing.assert_array_equal(x, y)
            for k in ("csr", "dense"):
                np.testing.assert_array_equal(a[(s, k)], b[(s, k)])
            assert a[(s, "ran")] == b[(s, "ran")] == s


# ------------------------------------------------------------- the dense LM

def test_fused_lookup_and_bag_at_lm_width(cuda):
    """Row 2 at an LM token table's width, d = 2,048 (tinyllama-1.1b's
    LMA table: 4,096,000 striped slots, max_set 32): the flat lookup
    bit-exact, and the bag, whose per-warp sums ask 66.5 KB of shared
    memory (past the 48 KB a launch gets without the opt-in)."""
    rng = np.random.default_rng(23)
    d, S = 2048, 32
    p = LMAParams(d=d, m=4_096_000, n_h=4, max_set=S, seed=0x2048_0017,
                  striped=True, min_support=2)
    spec = fe.lma_spec(p)
    mem = _mem(cuda, p.m)
    B, L = 24, 3
    sets = _sets(rng, B * L, S).to(cuda)
    support = torch.from_numpy(rng.integers(0, 6, B * L).astype(np.int32))
    gids = torch.from_numpy(rng.integers(0, 32000, B * L).astype(np.int32))
    support, gids = support.to(cuda), gids.to(cuda)
    assert (support < p.min_support).any()
    got = fe.fused_lookup(spec, mem, gids, sets, support)
    assert torch.equal(got, fref.fused_lookup_ref(spec, mem, gids, sets,
                                                  support))
    w = torch.from_numpy(rng.random((B, L)).astype(np.float32)).to(cuda)
    args = (gids.reshape(B, L), w, sets.reshape(B, L, S),
            support.reshape(B, L))
    torch.testing.assert_close(fe.fused_embed_bag(spec, mem, *args),
                               fref.fused_embed_bag_ref(spec, mem, *args),
                               rtol=1e-6, atol=1e-6)


def test_training_rows_at_lm_train_shape(cuda):
    """Rows 4, 5 and 9 at an LM token table's training shape (phase 38b's:
    tinyllama-1.1b's LMA table, d = 2,048 over 4,096,000 striped slots,
    max_set 32), 4,096 tokens with fallback rows and hot tokens repeated:
    row 4's locations bit-equal to ``locations_ref``; row 9 (lazy Adam on
    the flat pool) on the bucketed SparseGrad of those locations, 8,388,608
    entries, bit-equal to its plain version (updates, moments, untouched
    slots); row 5 within 1e-6 of each slot's sum |g|."""
    from repro_torch.optim.sparse import from_bucketed_locations
    rng = np.random.default_rng(2049)
    d, S, n = 2048, 32, 4096
    p = LMAParams(d=d, m=4_096_000, n_h=4, max_set=S, seed=0x2048_0017,
                  striped=True, min_support=2)
    spec = fe.lma_spec(p)
    sets = _sets(rng, n, S)
    support = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 32000, n).astype(np.int32))
    for t in (sets, support, ids):          # 64 tokens, 32 times each
        t[: n // 2] = t[:64].repeat((32,) + (1,) * (t.dim() - 1))
    sets, support, gids = sets.to(cuda), support.to(cuda), ids.to(cuda)
    assert (support < p.min_support).any()
    loc = fe.fused_locations(spec, gids, sets, support)
    assert torch.equal(loc, fref.locations_ref(spec, gids, sets, support))
    g = torch.randn((n, d), generator=torch.Generator(device=cuda)
                    .manual_seed(5), device=cuda) * 1e-3
    got = fk.fused_scatter_add_cuda(spec, g, gids, sets, support)
    want = fref.scatter_add_ref(spec, g, gids, sets, support)
    abs_sum = torch.zeros(p.m, device=cuda).index_add_(
        0, loc.reshape(-1).long(), g.abs().reshape(-1))
    assert bool(((got - want).abs() <= 1e-6 * abs_sum).all())
    sg = from_bucketed_locations(loc, g, (p.m,))
    assert sg.indices.numel() == n * d and not sg.unique
    _check_update(cuda, "adam", sg.indices.cpu().numpy(),
                  sg.values.cpu().numpy(), _states(cuda, "adam", (p.m,)),
                  unique=False)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_lm_prefill_and_decode_on_the_card(cuda, kv):
    """tinyllama's smoke config with an LMA token table on the card (row 2
    once per prefill and per decode step) against the same model on the
    CPU: token embeddings bit-equal, prefill logits within 1e-4 (float32
    matmuls and sums in another order); with a float cache the decode
    logits within 1e-4 too; with an int8 cache, whose K/V can round to
    neighbouring steps on the two sides, the cache one step apart at most
    and the decode logits within 5e-3 (an H100 read 4.3e-4 to 8.2e-4 over
    the four decode steps, with logits up to 4.2 in magnitude)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs._recsys_common import embedding_of_kind
    from repro_torch.core.signatures import synthetic_dense_store
    from repro_torch.embed import EmbeddingTable
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.models import transformer as tt

    base = get_config("tinyllama-1.1b").make_smoke()
    e = embedding_of_kind("lma", (base.vocab_size,), base.d_model,
                          expansion=16.0, max_set=32)
    cfg = dataclasses.replace(base, embedding=e, kv_cache_dtype=kv)
    store = synthetic_dense_store(base.vocab_size, 16, max_set=32, seed=0,
                                  device="cpu")
    host = tt.init(cfg, seed=1, device="cpu")
    card = tt.init(cfg, seed=1, device=cuda)
    card.load_state_dict(host.state_dict())
    hb = EmbeddingTable(e).make_buffers(store, device="cpu")
    cb = {k: v.to(cuda) for k, v in hb.items()}
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, base.vocab_size, (3, 20)).astype(np.int32))
    assert torch.equal(tt.embed_tokens(card, cfg, tok.to(cuda), cb).cpu(),
                       tt.embed_tokens(host, cfg, tok, hb))
    outs = []
    for model, bufs, dev in ((host, hb, "cpu"), (card, cb, cuda)):
        cache = tt.init_cache(cfg, 3, 24, dev)
        fused_lookup_cuda.launches = 0
        logits, cache = tt.prefill(model, cfg, tok.to(dev), bufs,
                                   cache=cache)
        steps = [logits]
        cur = logits.argmax(-1).to(torch.int32)
        for s in range(4):
            logits, cache = tt.decode_step(model, cfg, cur, cache, 20 + s,
                                           bufs)
            steps.append(logits)
            cur = logits.argmax(-1).to(torch.int32)
        assert fused_lookup_cuda.launches == (5 if dev == cuda else 0)
        outs.append(([x.cpu() for x in steps],
                     {k: v.cpu() for k, v in cache["layers_0"].items()}))
    (h_steps, h_cache), (c_steps, c_cache) = outs
    torch.testing.assert_close(h_steps[0], c_steps[0], rtol=1e-4, atol=1e-4)
    tol = dict(rtol=1e-4, atol=1e-4) if kv is None \
        else dict(rtol=0.0, atol=5e-3)
    for name in ("k", "v"):                        # the prefill's rows
        h, c = h_cache[name][:, :, :20], c_cache[name][:, :, :20]
        if kv is None:
            torch.testing.assert_close(h, c, rtol=1e-4, atol=1e-4)
        else:
            assert (h.int() - c.int()).abs().max() <= 1
    # each side decodes its own argmax: held while the inputs agree
    for i in range(1, len(h_steps)):
        if not torch.equal(h_steps[i - 1].argmax(-1),
                           c_steps[i - 1].argmax(-1)):
            break
        torch.testing.assert_close(h_steps[i], c_steps[i], **tol)


@pytest.mark.parametrize("concat", [True, False])
def test_gat_chunked_layer_matches_plain_on_the_card(cuda, concat):
    """The GAT's edge-chunked aggregation against ``gat_conv_plain`` on the
    card, forward and backward (x, w, a_src, a_dst), at a chunk that holds
    every edge and at one that splits in-edge lists; a masked padded tail
    onto an all-masked node and nodes with no in-edge.  Both sum by atomic
    adds in no fixed order: outputs within 1e-5 and gradients within 1e-4
    of the plain max |value|."""
    from repro_torch.models import gnn

    gen = torch.Generator(device=cuda).manual_seed(0)
    N, E, F, H, D, pad = 3000, 40_000, 24, 8, 7, 500
    src = torch.randint(0, N, (E + pad,), generator=gen, device=cuda,
                        dtype=torch.int32)
    dst = torch.randint(0, N - 10, (E + pad,), generator=gen, device=cuda,
                        dtype=torch.int32)
    dst[E:] = N - 1
    mask = torch.arange(E + pad, device=cuda) < E
    x = torch.randn((N, F), generator=gen, device=cuda)
    p = {"w": torch.randn((F, H, D), generator=gen, device=cuda) / F ** 0.5,
         "a_src": torch.randn((H, D), generator=gen, device=cuda),
         "a_dst": torch.randn((H, D), generator=gen, device=cuda)}
    cot = torch.randn((N, H * D if concat else D), generator=gen,
                      device=cuda)
    kw = dict(negative_slope=0.2, concat_heads=concat, edge_mask=mask)

    def run(fn, **extra):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xs = x.clone().requires_grad_()
        out = fn(leaves, xs, src, dst, N, **kw, **extra)
        grads = torch.autograd.grad((out * cot).sum(),
                                    [xs, *leaves.values()])
        return out.detach(), grads

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    want, want_g = run(gnn.gat_conv_plain)
    for chunk in (E + pad, 4093):
        got, got_g = run(gnn.gat_conv, chunk=chunk)
        assert rel(got, want) <= 1e-5, chunk
        assert not got[N - 10:].abs().any()
        for g, w in zip(got_g, want_g):
            assert rel(g, w) <= 1e-4, chunk


# ---------------------------------------------------- the MoE and MLA LMs

def test_fused_lookup_at_deepseek_width(cuda):
    """Row 2 at deepseek-v3's token table width, d = 7,168 (129,280 x
    7,168 at alpha = 16: 57,917,440 striped slots, max_set 32): the flat
    lookup bit-exact against its plain version, fallback rows included.
    Its shared memory is the warps' staged sets only, whatever d."""
    rng = np.random.default_rng(71)
    d, S = 7168, 32
    p = LMAParams(d=d, m=57_917_440, n_h=4, max_set=S, seed=0x7168_0019,
                  striped=True, min_support=2)
    spec = fe.lma_spec(p)
    mem = _mem(cuda, p.m)
    n = 300
    sets = _sets(rng, n, S).to(cuda)
    support = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    gids = torch.from_numpy(rng.integers(0, 129_280, n).astype(np.int32))
    support, gids = support.to(cuda), gids.to(cuda)
    assert (support < p.min_support).any()
    got = fe.fused_lookup(spec, mem, gids, sets, support)
    assert torch.equal(got, fref.fused_lookup_ref(spec, mem, gids, sets,
                                                  support))


# ------------------------------------------- row 2 at an LM's decode sizes

FEW_ROWS = (1, 3, 4, 8, 16, 128)


def _few_rows_case(cuda, scheme: str, n: int, d: int):
    """A pool of 64 slots a column (striped lma with fallback rows, else
    hashed) and n values: (spec, mem, gids, extra)."""
    rng = np.random.default_rng(n * 7919 + d)
    m = 64 * d
    if scheme != "lma":
        gids = torch.from_numpy(rng.integers(
            0, 2**31 - 1, n).astype(np.int32)).to(cuda)
        return fe.hashed_spec(scheme, d, m, 0x9E37_0029), _mem(cuda, m), \
            gids, ()
    S = 32
    p = LMAParams(d=d, m=m, n_h=4, max_set=S, seed=0x8B0A_D001, striped=True,
                  min_support=2)
    sets = _sets(rng, n, S, empty_rows=min(n, 1)).to(cuda)
    support = rng.integers(0, 6, n).astype(np.int32)
    support[0] = 0                  # a fallback row at every n
    gids = rng.integers(2**31 - 200_000, 2**31 - 1, n).astype(np.int32)
    return fe.lma_spec(p), _mem(cuda, m), torch.from_numpy(gids).to(cuda), \
        (sets, torch.from_numpy(support).to(cuda))


@pytest.mark.parametrize("d", [64, 2048, 7168])
@pytest.mark.parametrize("n", FEW_ROWS)
@pytest.mark.parametrize("scheme", ["lma", "hashed_elem", "hashed_row"])
def test_few_row_lookup_bit_equal(cuda, scheme, n, d):
    """Row 2 at few rows, where the launch splits each row's columns into
    tiles (``lookup_tile``): the flat lookup bit-equal to its plain version,
    and in slab mode; the bag bit-equal to the plain gather summed in l
    order, product then sum (the kernel's order), and within 1e-6 of
    ``fused_embed_bag_ref``; every forced tile (32, 64, 96, d) gives the
    same bits."""
    spec, mem, gids, extra = _few_rows_case(cuda, scheme, n, d)
    assert fk.lookup_tile(n, d, fk.sm_count(mem.device.index)) < d
    got = fk.fused_lookup_cuda(spec, mem, gids, *extra)
    assert torch.equal(got, fref.fused_lookup_ref(spec, mem, gids, *extra))
    for forced in (32, 64, 96, d):
        assert torch.equal(fk.fused_lookup_cuda(spec, mem, gids, *extra,
                                                tile=forced), got), forced
    base, m_local = spec.m // 4, spec.m // 2
    slab = mem[base:base + m_local].contiguous()
    assert torch.equal(
        fk.fused_lookup_cuda(spec, slab, gids, *extra, base=base),
        fref.fused_lookup_ref(spec, slab, gids, *extra, base=base))
    L = 3
    bg = torch.cat([gids, gids.flip(0), gids.roll(1)]).reshape(L, n).T
    bx = [torch.cat([x, x.flip(0), x.roll(1, 0)]).reshape(
        (L, n) + x.shape[1:]).transpose(0, 1).contiguous() for x in extra]
    w = torch.from_numpy(np.random.default_rng(n).random(
        (n, L)).astype(np.float32)).to(cuda)
    e = fref.fused_lookup_ref(spec, mem, bg.reshape(-1),
                              *(x.reshape((n * L,) + x.shape[2:])
                                for x in bx)).reshape(n, L, d)
    want = torch.zeros((n, d), device=cuda)
    for li in range(L):
        want = want + w[:, li:li + 1] * e[:, li]
    bag = fk.fused_lookup_cuda(spec, mem, bg.contiguous(), *bx, weights=w)
    assert torch.equal(bag, want)
    torch.testing.assert_close(
        bag, fref.fused_embed_bag_ref(spec, mem, bg, w, *bx), rtol=1e-6,
        atol=1e-6)
    for forced in (32, 64) + ((d,) if d <= 2048 else ()):
        assert torch.equal(fk.fused_lookup_cuda(
            spec, mem, bg.contiguous(), *bx, weights=w, tile=forced), bag)


def test_lookup_rejects_a_ragged_tile(cuda):
    spec = fe.hashed_spec("hashed_elem", 2048, 64 * 2048, 1)
    gids = torch.zeros(4, dtype=torch.int32, device=cuda)
    mem = torch.zeros(spec.m, device=cuda)
    for tile in (0, 48, -32):
        with pytest.raises(ValueError, match="tile"):
            fk.fused_lookup_cuda(spec, mem, gids, tile=tile)


# ------------------------- rows 4 and 10 at a rank's few-row chunk

CHUNK_ROWS = (1, 4, 16, 512)


@pytest.mark.parametrize("d", [2048, 7168, 64, 18, 10])
@pytest.mark.parametrize("n", CHUNK_ROWS)
@pytest.mark.parametrize("scheme", ["lma", "hashed_elem", "hashed_row"])
def test_few_row_locations_and_chunk_lookup_bit_equal(cuda, scheme, n, d):
    """Rows 4 and 10 at a rank's few-row chunk, where the launch splits each
    row's columns into tiles (``lookup_tile``: 32, or d when narrower): the
    locations bit-equal to ``locations_ref``, and the chunk lookup's
    partial and locations to ``chunk_lookup_ref`` on each quarter of the
    pool as the slab (base > 0 on three; each location lies in one
    quarter, so both sides of the mask occur), at the default tile and at
    every forced tile (32, 64, 96, d)."""
    spec, mem, gids, extra = _few_rows_case(cuda, scheme, n, d)
    assert fk.lookup_tile(n, d, fk.sm_count(mem.device.index)) == min(32, d)
    want = fref.locations_ref(spec, gids, *extra)
    for forced in (None, 32, 64, 96, d):
        assert torch.equal(fk.fused_locations_cuda(spec, gids, *extra,
                                                   tile=forced), want), forced
    m_local = spec.m // 4
    in_slab = 0
    for base in range(0, spec.m, m_local):
        slab = mem[base:base + m_local]
        part = fref.chunk_lookup_ref(spec, slab, gids, *extra, base=base)[0]
        in_slab += int(((want >= base) & (want < base + m_local)).sum())
        for forced in (None, 32, 64, 96, d):
            got_part, got_loc = fk.fused_chunk_lookup_cuda(
                spec, slab, gids, *extra, base=base, tile=forced)
            assert torch.equal(got_loc, want), (base, forced)
            assert torch.equal(got_part, part), (base, forced)
    assert in_slab == n * d


def test_locations_and_chunk_lookup_reject_a_ragged_tile(cuda):
    spec = fe.hashed_spec("hashed_elem", 2048, 64 * 2048, 1)
    gids = torch.zeros(4, dtype=torch.int32, device=cuda)
    mem = torch.zeros(spec.m, device=cuda)
    for tile in (0, 48, -32):
        with pytest.raises(ValueError, match="tile"):
            fk.fused_locations_cuda(spec, gids, tile=tile)
        with pytest.raises(ValueError, match="tile"):
            fk.fused_chunk_lookup_cuda(spec, mem, gids, tile=tile)


def test_blocks_per_sm_of_the_tiled_kernels(cuda):
    """The occupancy API's blocks of 8 warps an SM for the three tiled
    kernels at S = 32: at least one, at most the 8 that 64 warps allow."""
    for kernel in ("lookup", "locations", "chunk_lookup"):
        for tile in (32, 2048):
            assert 1 <= fk.blocks_per_sm(kernel, 32, tile) <= 8, kernel
    assert 1 <= fk.blocks_per_sm("lookup", 32, 2048, bag=True) <= 8


@pytest.mark.parametrize("E,T,k", [(4, 512, 160), (16, 32768, 2560),
                                   (256, 1024, 40)])
def test_stable_top_c_on_the_card_equals_the_cpu(cuda, E, T, k):
    """The MoE's per-expert top-C over tied routing weights (top-1: every
    routed weight exactly 1.0; a few distinct values): the card's stable
    sort keeps the same tokens, in the same order, as the CPU's, ties to
    the lower token index."""
    from repro_torch.nn.moe import top_k
    rng = np.random.default_rng(E)
    choice = rng.integers(0, E, T)
    R = np.zeros((T, E), np.float32)
    R[np.arange(T), choice] = 1.0
    R[rng.random(T) < 0.1, :] *= 0.5
    RT = torch.from_numpy(np.ascontiguousarray(R.T))
    want_v, want_i = top_k(RT, k)
    got_v, got_i = top_k(RT.to(cuda), k)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu(), want_v)
    tied = want_v[:, 1:] == want_v[:, :-1]   # ties to the lower index
    assert bool((want_i[:, 1:] > want_i[:, :-1])[tied].all())


def test_moe_apply_on_the_card_equals_the_cpu(cuda):
    """llama4-scout's smoke experts, float32, top-1 past capacity (the
    router pulled to expert 0): the same tokens kept on the card as on
    the CPU, outputs within 1e-4 (float32 products in another order) and
    aux within 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.nn import moe
    cfg = get_config("llama4-scout-17b-a16e").make_smoke().moe
    host = moe.moe_init(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        host.router.weight[:, 0] = 0.0
        host.router.weight[0, 0] = 50.0
    card = moe.moe_init(cfg, torch.Generator(device=cuda).manual_seed(0),
                        cuda)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(3)
    x = rng.normal(size=(512, cfg.d_model)).astype(np.float32)
    x[:, 0] = np.where(rng.random(512) < 0.8, 1.0, -1.0)
    x = torch.from_numpy(x)
    with torch.no_grad():
        want, waux = moe.moe_apply(host, cfg, x)
        got, aux = moe.moe_apply(card, cfg, x.to(cuda))
    assert int((moe.route(host, cfg, x)[2] == 0).sum()) > \
        moe.moe_capacity(cfg, 512)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), waux, rtol=1e-6, atol=1e-6)


def test_ipc_all_gather_equals_the_staged_one(cuda):
    """Ranks sharing one card gather through CUDA IPC: on a (2, 2) mesh of
    4 gloo ranks on cuda:0, every axis's ``all_gather`` bit-equal to the
    host-staged gather, for float32, bf16 and int32 of 28 B (gloo) and of
    6 and 12 MB (IPC: one call a dtype and axis)."""
    from lm_mesh_ranks import gather_paths_rank
    from repro_torch.dist.collectives import run_ranks

    for r in run_ranks(gather_paths_rank, 4, data=2, device="cuda:0"):
        calls = r.pop("ipc_calls")
        assert all(r.values()), r
        assert calls == {"model": 3, "data": 3, "world": 3}


# ------------------- row 5: one cooperative grid, the fill under the hashing

ROW5_SCHEMES = ["lma", "lma_striped", "lma_fallback", "hashed_elem",
                "hashed_row"]


def _row5_case(cuda, scheme, n, d=64, seed=0):
    """(spec, gids [n], extra) on a pool of d * 4,099 slots (+ 3 where not
    striped, so that m % 4 != 0 leaves a tail past the float4 fill):
    lma with S = 32 (a tenth of the values under min_support, nine tenths
    for lma_fallback) or a hashed scheme; half the values repeat 64 hot
    ids, whose slots collect long runs of atomics."""
    rng = np.random.default_rng(seed + 31 * n + d)
    striped = scheme == "lma_striped"
    m = d * 4099 + (0 if striped else 3)
    ids = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    hot = min(64, n)
    ids[: n // 2] = np.resize(ids[:hot], n // 2)
    gids = torch.from_numpy(ids).to(cuda)
    if scheme.startswith("hashed"):
        return fe.hashed_spec(scheme, d, m, 0x5CA7_0005), gids, ()
    p = LMAParams(d=d, m=m, n_h=4, max_set=32, seed=0x5CA7_0005,
                  striped=striped, min_support=2)
    sets = _sets(rng, n, 32, empty_rows=min(n, 3))
    sets[: n // 2] = sets[:hot].repeat(-(-(n // 2) // hot), 1)[: n // 2]
    support = rng.integers(2, 6, n).astype(np.int32)
    support[rng.random(n) < (0.9 if scheme == "lma_fallback" else 0.1)] = 0
    support[: n // 2] = np.resize(support[:hot], n // 2)
    return fe.lma_spec(p), gids, (sets.to(cuda),
                                  torch.from_numpy(support).to(cuda))


def _row5_held(spec, g, gids, extra, weights=None, base=0, m_local=None,
               **kw):
    """Row 5 against ``scatter_add_ref``, each slot within 1e-6 of its sum
    |g| (bag: |g * w|); -> the kernel's dM."""
    m_local = spec.m if m_local is None else m_local
    got = fk.fused_scatter_add_cuda(spec, g, gids, *extra, weights=weights,
                                    base=base, m_local=m_local, **kw)
    want = fref.scatter_add_ref(spec, g, gids, *extra, weights=weights,
                                base=base, m_local=m_local)
    flat = tuple(x.reshape((gids.numel(),) + x.shape[gids.dim():])
                 for x in extra)
    loc = fref.locations_ref(spec, gids.reshape(-1), *flat)
    contrib = g if weights is None else \
        (g[:, None, :] * weights[:, :, None]).reshape(-1, spec.d)
    assert got.shape == (m_local,) and not bool(got.isnan().any())
    _held_to_sum_abs(got, want, loc, contrib, base, m_local)
    return got


def _as_bag(gids, extra, L):
    B = gids.numel() // L
    return gids.reshape(B, L), tuple(x.reshape((B, L) + x.shape[1:])
                                     for x in extra)


@pytest.mark.parametrize("scheme", ROW5_SCHEMES)
def test_row5_flat_and_bag_match_plain(cuda, scheme):
    """Flat (3,042 values) and as a bag of 26 (117 rows) at d = 64, every
    scheme, the A_h fallback rare and dominant, hot slots contended."""
    spec, gids, extra = _row5_case(cuda, scheme, 3042)
    g = torch.randn((3042, 64), device=cuda)
    _row5_held(spec, g, gids, extra)
    bg, bx = _as_bag(gids, extra, 26)
    w = torch.rand(bg.shape, device=cuda)
    _row5_held(spec, g[:117].contiguous(), bg, bx, weights=w)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
@pytest.mark.parametrize("scheme", ROW5_SCHEMES)
def test_row5_slab_at_every_rank(cuda, scheme, rank):
    """Slab mode at each quarter of the pool (phase 34's (1, 4) split),
    flat and bag: in-slab slots summed, the rest of the pool untouched."""
    spec, gids, extra = _row5_case(cuda, scheme, 1300, seed=rank)
    m_local = spec.m // 4
    base = rank * m_local
    g = torch.randn((1300, 64), device=cuda)
    _row5_held(spec, g, gids, extra, base=base, m_local=m_local)
    bg, bx = _as_bag(gids, extra, 26)
    w = torch.rand(bg.shape, device=cuda)
    _row5_held(spec, g[:50].contiguous(), bg, bx, weights=w, base=base,
               m_local=m_local)


@pytest.mark.parametrize("n", [0, 5000])
@pytest.mark.parametrize("slab", [False, True])
def test_row5_zeroes_a_reused_nan_buffer(cuda, slab, n):
    """The kernel owns the fill: a same-size NaN-filled tensor is freed
    right before the call, so the wrapper's ``torch.empty`` takes its
    memory back (the same address), and a slot the fill missed would stay
    NaN.  With no rows at all the buffer comes back all zeros."""
    spec, gids, extra = _row5_case(cuda, "lma", max(n, 1))
    gids, extra = gids[:n], tuple(x[:n] for x in extra)
    base, m_local = (spec.m // 4, spec.m // 2) if slab else (0, spec.m)
    g = torch.randn((n, 64), device=cuda)
    junk = torch.full((m_local,), float("nan"), device=cuda)
    where = junk.data_ptr()
    del junk
    got = _row5_held(spec, g, gids, extra, base=base, m_local=m_local)
    assert got.data_ptr() == where
    if n == 0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("bag", [False, True])
def test_row5_more_values_than_the_staging_holds(cuda, bag):
    """More values than the grid can stage before its barrier (warps 1-7
    of every block, 5 values of d = 64 each, at the card's own grid,
    ``scatter_grid``), so that values are staged and others hashed after
    the barrier; both kinds summed.  The bag's first values of a row go to
    one warp's staging and its later ones to others."""
    from kernel_schedules import STAGE_ROUNDS
    n, L = (156_000, 26) if bag else (150_000, 1)
    spec, gids, extra = _row5_case(cuda, "lma_striped", n)
    S = extra[0].shape[-1]
    grid = fk.scatter_grid(cuda.index or 0, S)
    bps = fk.blocks_per_sm("scatter", S, 0)
    assert bps >= 1 and grid == bps * fk.sm_count(cuda.index or 0)
    assert n > grid * 7 * (STAGE_ROUNDS // 2)
    rows = n // L
    g = torch.randn((rows, 64), device=cuda)
    if bag:
        bg, bx = _as_bag(gids, extra, L)
        _row5_held(spec, g, bg, bx, weights=torch.rand(bg.shape,
                                                       device=cuda))
    else:
        _row5_held(spec, g, gids, extra)


@pytest.mark.parametrize("d", [64, 2048])
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("scheme", ["lma", "hashed_elem", "hashed_row"])
def test_row5_at_few_rows(cuda, scheme, n, d):
    """1-16 rows, where most of the persistent grid's blocks only fill:
    flat and as a bag of 3, at the wrapper's tile (d = 2,048: 32 columns;
    d = 64: the whole row)."""
    spec, _, gids, extra = _few_rows_case(cuda, scheme, n, d)
    g = torch.randn((n, d), device=cuda)
    _row5_held(spec, g, gids, extra)
    L = 3
    bg = torch.cat([gids, gids.flip(0), gids.roll(1)]).reshape(L, n).T
    bx = tuple(torch.cat([x, x.flip(0), x.roll(1, 0)]).reshape(
        (L, n) + x.shape[1:]).transpose(0, 1).contiguous() for x in extra)
    w = torch.rand((n, L), device=cuda)
    _row5_held(spec, g, bg.contiguous(), bx, weights=w)


def test_row5_under_cuda_graph_capture(cuda):
    """The cooperative launch captured in a CUDA graph (as ``graph_ms``
    times it): each replay refills the graph's own buffer, NaN-poisoned
    between replays, and sums as the plain version does; the capture
    counts one launch."""
    spec, gids, extra = _row5_case(cuda, "lma_striped", 4000)
    g = torch.randn((4000, 64), device=cuda)
    want = fref.scatter_add_ref(spec, g, gids, *extra)
    loc = fref.locations_ref(spec, gids, *extra)
    fk.fused_scatter_add_cuda(spec, g, gids, *extra)      # warm, off graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = fk.fused_scatter_add_cuda.launches
    with torch.cuda.graph(graph):
        out = fk.fused_scatter_add_cuda(spec, g, gids, *extra)
    assert fk.fused_scatter_add_cuda.launches == before + 1
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert not bool(out.isnan().any())
        _held_to_sum_abs(out, want, loc, g, 0, spec.m)


def test_row5_refused_cooperative_launch_raises(cuda, monkeypatch):
    """A grid the card cannot hold at once is refused by the cooperative
    launch: the wrapper raises (no fallback), and the next call runs."""
    spec, gids, extra = _row5_case(cuda, "hashed_elem", 100)
    g = torch.randn((100, 64), device=cuda)
    monkeypatch.setattr(fk, "scatter_grid", lambda index, S: 1 << 20)
    with pytest.raises(RuntimeError, match="fused_scatter_add"):
        fk.fused_scatter_add_cuda(spec, g, gids)
    monkeypatch.undo()
    _row5_held(spec, g, gids, extra)
