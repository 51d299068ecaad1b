"""D' signature store: the data subsample that defines semantic similarity.

Port of ``repro.core.signatures``.  ``DenseSignatureStore`` is the
fixed-width form the lookups read: ``[n_values, max_set]`` sets padded with
PAD = 0xFFFFFFFF.  PyTorch has no usable uint32, so the sets are stored as
int32 bit patterns (PAD = -1); the CUDA kernels reinterpret them as uint32
and the plain versions widen them with ``hashing.u32``.

The numpy builders are copies of the reference's, so the same data or seed
gives the same store in both packages.  ``build_signature_store`` builds the
CSR store from data rows (the launcher's D'), ``synthetic_signature_store``
a planted one; ``densify_store`` turns either into the fixed-width form on
the device.  A CSR store also serves lookups as it is (the LMA scheme's
``store_flat`` / ``store_offsets`` buffers).  ``planted_dense_store`` builds
the same planted-cluster structure directly on the device, for stores too
large for the host (the numpy builder needs ~9 GB of float64 at Criteo
scale).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.device import make_generator, resolve_device

PAD = 0xFFFFFFFF   # stored as the int32 bit pattern -1


@dataclasses.dataclass(frozen=True)
class DenseSignatureStore:
    """Fixed-width D_v store: sets [n_values, max_set] int32 bit patterns of
    uint32 sample ids (PAD = -1), lengths [n_values] int32."""

    sets: torch.Tensor
    lengths: torch.Tensor

    PAD = PAD

    @property
    def n_values(self) -> int:
        return self.sets.shape[0]

    @property
    def max_set(self) -> int:
        return self.sets.shape[1]


@dataclasses.dataclass(frozen=True)
class SignatureStore:
    """CSR ragged store of D_v per global value id: numpy arrays on the host
    as the builders make it (``flat`` uint32), or tensors on a device as the
    LMA scheme's buffers hold it (``flat`` int32 bit patterns)."""

    flat: np.ndarray       # [nnz] sample ids, concatenated per value
    offsets: np.ndarray    # [n_values + 1] int32
    lengths: np.ndarray    # [n_values] int32 (== diff(offsets))

    @property
    def n_values(self) -> int:
        return self.lengths.shape[0]

    @property
    def nnz(self) -> int:
        return self.flat.shape[0]


def build_signature_store(rows: Iterable[np.ndarray], n_values: int,
                          max_per_value: int = 128,
                          n_samples: int | None = None) -> SignatureStore:
    """D' from a subsample of the data (copy of the reference).

    ``rows`` yields, per sample, the *global* value ids present in it.
    ``n_samples`` rows are used (all, if None); per-value sets keep the
    first ``max_per_value`` sample ids."""
    buckets: list[list[int]] = [[] for _ in range(n_values)]
    for sample_id, row in enumerate(rows):
        if n_samples is not None and sample_id >= n_samples:
            break
        for v in np.asarray(row).ravel():
            b = buckets[int(v)]
            if len(b) < max_per_value:
                b.append(sample_id)
    lengths = np.array([len(b) for b in buckets], dtype=np.int32)
    offsets = np.zeros(n_values + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    flat = np.empty(int(offsets[-1]), dtype=np.uint32)
    for v, b in enumerate(buckets):
        flat[offsets[v]: offsets[v + 1]] = b
    return SignatureStore(flat=flat, offsets=offsets, lengths=lengths)


def synthetic_signature_store(n_values: int, n_clusters: int,
                              samples_per_value: int = 32,
                              overlap: float = 0.9,
                              seed: int = 0) -> SignatureStore:
    """A CSR store with *planted* cluster structure (copy of the reference):
    values of one cluster draw their sample ids from a shared pool (Jaccard
    ~= ``overlap``), values of different clusters from disjoint pools."""
    rng = np.random.default_rng(seed)
    pool_size = max(8, int(samples_per_value / max(overlap, 1e-3)))
    lengths = np.full(n_values, samples_per_value, dtype=np.int32)
    offsets = np.zeros(n_values + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    flat = np.empty(int(offsets[-1]), dtype=np.uint32)
    for v in range(n_values):
        c = v % n_clusters
        pool_base = c * (1 << 16)
        ids = rng.choice(pool_size, size=samples_per_value, replace=False)
        flat[offsets[v]: offsets[v + 1]] = (pool_base + ids).astype(np.uint32)
    return SignatureStore(flat=flat, offsets=offsets, lengths=lengths)


def table_offsets(vocab_sizes) -> np.ndarray:
    """Global-id bases for common-memory multi-table LMA (paper sec 5)."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes))]
                          ).astype(np.int64)


def csr_on(store, device) -> SignatureStore:
    """A CSR store (the port's or the reference's, numpy or tensors) as
    tensors on ``device``: ``flat`` as int32 bit patterns, ``offsets`` and
    ``lengths`` int32."""
    dev = resolve_device(device)

    def put(a, bits: bool = False):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        a = np.ascontiguousarray(a)
        if bits and a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(np.int32, copy=False)).to(dev)

    return SignatureStore(flat=put(store.flat, bits=True),
                          offsets=put(store.offsets),
                          lengths=put(store.lengths))


def _to_store(sets_u32: np.ndarray, lengths: np.ndarray,
              device) -> DenseSignatureStore:
    dev = resolve_device(device)
    sets = torch.from_numpy(np.ascontiguousarray(sets_u32).view(np.int32))
    return DenseSignatureStore(sets=sets.to(dev),
                               lengths=torch.from_numpy(lengths).to(dev))


def densify_store(store, max_set: int, n_rows: int | None = None,
                  device=None) -> DenseSignatureStore:
    """CSR -> fixed-width.  ``store`` is any CSR store with ``flat``,
    ``offsets`` and ``lengths`` arrays (the reference's ``SignatureStore``
    included); ``n_rows`` pads the row count."""
    flat = np.asarray(store.flat)
    offsets = np.asarray(store.offsets)
    lengths = np.asarray(store.lengths)
    n = lengths.shape[0]
    rows = max(n_rows or n, n)
    sets = np.full((rows, max_set), PAD, np.uint32)
    for v in range(n):
        k = min(int(lengths[v]), max_set)
        sets[v, :k] = flat[offsets[v]: offsets[v] + k]
    out_len = np.zeros(rows, np.int32)
    out_len[:n] = np.minimum(lengths, max_set)
    return _to_store(sets, out_len, device)


def synthetic_dense_store(n_values: int, n_clusters: int, max_set: int = 32,
                          overlap: float = 0.9, seed: int = 0,
                          device=None) -> DenseSignatureStore:
    """Vectorized planted-cluster dense store (copy of the reference)."""
    rng = np.random.default_rng(seed)
    pool_size = max(8, int(max_set / max(overlap, 1e-3)))
    clusters = (np.arange(n_values, dtype=np.int64) % n_clusters)
    keys = rng.random((n_values, pool_size))
    picks = np.argsort(keys, axis=1)[:, :max_set].astype(np.uint32)
    sets = (clusters[:, None].astype(np.uint32) << np.uint32(16)) + picks
    lengths = np.full(n_values, max_set, np.int32)
    return _to_store(sets, lengths, device)


def planted_dense_store(n_values: int, n_clusters: int, max_set: int = 32,
                        overlap: float = 0.9, seed: int = 0, device=None,
                        chunk: int = 1 << 22) -> DenseSignatureStore:
    """``synthetic_dense_store``'s structure, drawn on ``device`` in chunks.

    Row v holds ``max_set`` distinct picks from its cluster's pool of
    ``max_set / overlap`` ids, stored as ``cluster << 16 | pick`` with
    cluster = v % n_clusters.  The draws come from a torch generator, so the
    sets differ from the numpy builder's for the same seed; the distribution
    is the same."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    pool_size = max(8, int(max_set / max(overlap, 1e-3)))
    sets = torch.empty((n_values, max_set), dtype=torch.int32, device=dev)
    for lo in range(0, n_values, chunk):
        hi = min(lo + chunk, n_values)
        keys = torch.rand((hi - lo, pool_size), generator=gen, device=dev)
        picks = torch.argsort(keys, dim=1)[:, :max_set]
        clusters = torch.arange(lo, hi, device=dev) % n_clusters
        sets[lo:hi] = ((clusters[:, None] << 16) + picks).to(torch.int32)
    lengths = torch.full((n_values,), max_set, dtype=torch.int32, device=dev)
    return DenseSignatureStore(sets=sets, lengths=lengths)
