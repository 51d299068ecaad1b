"""The port's exchange cost model against the reference's, and the
distribution layer's refusals (no ranks are spawned here).

- ``lookup_cost``, ``resolve_exchange`` (a mesh stand-in with ``shape`` and
  ``axis_names``), ``resolve_update_exchange``, ``slab_aligned`` and the
  sparse-update cost model (``dedup_sort_bytes``, ``sparse_update_cost``,
  ``sparse_worthwhile``) equal to the reference's on a grid of (P, n, d,
  m, alloc_row, fused flags, buckets, row mode).  Where ``resolve_exchange`` derives a fused flag from m, the
  grid's m lies where the reference's VMEM gates pass, which the port (no
  VMEM gate) always does for a pool P divides.
- A mesh's axes, its data-major world and its ranks' bounds; a store whose
  rows do not divide by P, a pool that P does not divide, and NCCL with two
  ranks on one device each raise a clear error.
"""
from __future__ import annotations

import itertools
import types

import pytest

torch = pytest.importorskip("torch")

from repro.dist import exchange as jexl  # noqa: E402
from repro.dist import sharded_memory as jsm  # noqa: E402
from repro_torch.dist import collectives as col  # noqa: E402
from repro_torch.dist import exchange as exl  # noqa: E402
from repro_torch.dist import sharded_memory as sm  # noqa: E402
from repro_torch.dist.context import (Mesh, axis_sizes, constrain,  # noqa: E402
                                      dp_axes, use_mesh)
from repro_torch.dist.sharding import pad_rows, store_rows  # noqa: E402
from repro_torch.embed import EmbeddingTable, get_scheme  # noqa: E402


def _mesh(P):
    return types.SimpleNamespace(shape={"data": 1, "model": P},
                                 axis_names=("data", "model"))


PS = (1, 2, 4, 8)
NS = (4096, 13_312, 1_703_936, 4097)
DS = (16, 64)
ALLOC = (None, 0.0, 8 * 64 + 8 * 32)
FLAGS = (None, False, True)


@pytest.mark.parametrize("P", PS)
def test_lookup_cost_equals_reference(P):
    for n, d, a, f, fc in itertools.product(NS, DS, ALLOC, (False, True),
                                            (False, True)):
        assert exl.lookup_cost(P, n, d, a, f, fc) == \
            jexl.lookup_cost(P, n, d, a, f, fc)
    assert exl.alloc_bytes_per_row(64, 32) == jexl.alloc_bytes_per_row(64,
                                                                       32)


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("m", [None, 1 << 20])
def test_resolve_exchange_equals_reference(P, m):
    assert jexl.FORCED is None and exl.FORCED is None
    for n, d, a, f, fc in itertools.product(NS, DS, ALLOC, FLAGS, FLAGS):
        got = exl.resolve_exchange(_mesh(P), n, d, m, None, a, f, fc)
        want = jexl.resolve_exchange(_mesh(P), n, d, m, None, a, f, fc)
        assert got.name == want.name, (n, d, a, f, fc)
    assert exl.resolve_exchange(None).name == "psum"
    assert exl.resolve_exchange(_mesh(P)).name == \
        jexl.resolve_exchange(_mesh(P)).name


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("row_mode", [False, True])
def test_sparse_costs_equal_reference(P, row_mode):
    for n, d, b in itertools.product((4096, 1_703_936), DS, (0, 16, 64, 24)):
        k = n if row_mode else n * d
        for unique in (False, True):
            assert sm.slab_aligned(unique, b, k, P) == \
                jsm.slab_aligned(unique, b, k, P)
    assert exl.resolve_update_exchange(_mesh(P)).name == \
        jexl.resolve_update_exchange(_mesh(P)).name


@pytest.mark.parametrize("forced", ["psum", "ring", "all_to_all"])
def test_forced_strategy_equals_reference(forced):
    exl.FORCED = jexl.FORCED = forced
    try:
        for P in PS:
            assert exl.resolve_exchange(_mesh(P), 4096, 64).name == \
                jexl.resolve_exchange(_mesh(P), 4096, 64).name
            assert exl.resolve_update_exchange(_mesh(P)).name == \
                jexl.resolve_update_exchange(_mesh(P)).name
    finally:
        exl.FORCED = jexl.FORCED = None


def test_eligibility_and_gates():
    for P, n in itertools.product(PS, NS):
        for name in ("psum", "ring", "all_to_all"):
            assert exl.get_exchange(name).eligible(n, P) == \
                jexl.get_exchange(name).eligible(n, P)
    assert exl.list_exchanges() == jexl.list_exchanges()
    with pytest.raises(KeyError):
        exl.get_exchange("bogus")
    # no VMEM gate: any whole slab (the reference's gates refuse this one)
    m = 135_053_312
    assert exl.fused_chunk_eligible(m, 4) and exl.fused_slab_eligible(m, 4)
    assert not jexl.fused_slab_eligible(m, 4)
    assert not exl.fused_chunk_eligible(m + 1, 4)
    assert not exl.fused_slab_eligible(m + 1, 4)
    assert not exl.fused_chunk_eligible(m, 1) and exl.fused_slab_eligible(m, 1)
    assert store_rows(33_762_577) == 33_762_816 == \
        -(-33_762_577 // 512) * 512
    padded = pad_rows(torch.arange(6, dtype=torch.int32), 8, -1)
    assert padded.tolist() == [0, 1, 2, 3, 4, 5, -1, -1]
    with pytest.raises(ValueError):
        pad_rows(padded, 4, 0)


def test_mesh_with_a_data_axis():
    """A (data=2, model=2) mesh numbers its world data-major, as the
    reference's ``jax.make_mesh((D, P), ("data", "model"))``; a (1, P) mesh
    is what it was."""
    for w in range(4):
        m = Mesh(model=2, rank=w % 2, data=2, data_rank=w // 2)
        assert m.shape == {"data": 2, "model": 2} and m.world == 4
        assert m.world_rank == w and dp_axes(m) == ("data",)
    with pytest.raises(ValueError):
        Mesh(model=2, data=2, data_rank=2)
    mesh = Mesh(model=4, rank=1)
    assert mesh.world == 4 and mesh.world_rank == 1 and mesh.data_rank == 0
    assert mesh.shape == {"data": 1, "model": 4}
    assert dp_axes(mesh) == ("data",) and dp_axes() == ()
    assert axis_sizes() == {}
    x = torch.ones(3)
    with use_mesh(mesh):
        assert axis_sizes() == {"data": 1, "model": 4}
        assert constrain(x, [["data"]]) is x
    with pytest.raises(ValueError):
        Mesh(model=4, rank=4)


def test_store_rows_must_divide_over_the_ranks():
    e = get_scheme("lma").build_config((200, 313), 16, 4096, max_set=8)
    table = EmbeddingTable(e)
    from repro_torch.core.signatures import DenseSignatureStore
    store = DenseSignatureStore(torch.zeros((513, 8), dtype=torch.int32),
                                torch.zeros(513, dtype=torch.int32))
    with pytest.raises(ValueError, match="store_rows"):
        table.make_buffers(store, mesh=Mesh(model=4, rank=0))
    bufs = table.make_buffers(store, mesh=Mesh(model=3, rank=2))
    assert bufs["store_sets"].shape == (171, 8)
    # a pool P does not divide has no slabs
    with pytest.raises(ValueError):
        table.init(torch.Generator().manual_seed(0), device="cpu",
                   mesh=Mesh(model=3, rank=0))


def test_slab_init_is_the_single_device_pool_cut():
    e = get_scheme("hashed_elem").build_config((512,), 16, 4096)
    table = EmbeddingTable(e)
    whole = table.init(torch.Generator().manual_seed(0), device="cpu")
    for r in range(4):
        part = table.init(torch.Generator().manual_seed(0), device="cpu",
                          mesh=Mesh(model=4, rank=r))
        assert torch.equal(part["memory"],
                           whole["memory"][r * 1024:(r + 1) * 1024])


def test_nccl_refuses_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="one device"):
        col.run_ranks(print, 2, backend="nccl", device="cuda:0")
    with pytest.raises(ValueError, match="CUDA"):
        col.run_ranks(print, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError):
        col.run_ranks(print, 2, backend="mpi")


def test_lma_under_a_mesh_never_gathers_the_store_locally():
    e = get_scheme("lma").build_config((512,), 16, 4096, max_set=8)
    with use_mesh(Mesh(model=4)), pytest.raises(RuntimeError,
                                                match="exchange"):
        get_scheme("lma").fused_inputs(e, {}, torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("row_mode", [False, True])
def test_sparse_update_cost_model_equals_reference(P, row_mode):
    """``dedup_sort_bytes``, ``sparse_update_cost`` and
    ``sparse_worthwhile`` (the reference's sparse-vs-dense gate, also under
    each forced strategy) equal the reference's over a grid of n, d, m and
    buckets."""
    for k, b in itertools.product((0, 1, 2, 4096, 13_312, 1_703_936),
                                  (0, 16, 64, 24)):
        assert exl.dedup_sort_bytes(k, b) == jexl.dedup_sort_bytes(k, b)
    for n, d, m, b in itertools.product((4096, 13_312, 1_703_936), DS,
                                        (1 << 20, 135_053_312),
                                        (0, 16, 64, 24)):
        assert exl.sparse_update_cost(P, n, d, m, row_mode, b) == \
            jexl.sparse_update_cost(P, n, d, m, row_mode, b)
        for forced in (None, "psum", "ring", "all_to_all"):
            exl.FORCED = jexl.FORCED = forced
            try:
                assert exl.sparse_worthwhile(_mesh(P), n, d, m, row_mode,
                                             b) == \
                    jexl.sparse_worthwhile(_mesh(P), n, d, m, row_mode, b)
            finally:
                exl.FORCED = jexl.FORCED = None
    assert exl.sparse_worthwhile(None, 4096, 64, 1 << 20) == \
        jexl.sparse_worthwhile(None, 4096, 64, 1 << 20)
