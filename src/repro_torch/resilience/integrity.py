"""Pool integrity: chunked checksums, corruption scan, chunk quarantine
(port of ``repro.resilience.integrity``).

* **In-run scan** (``sanitize`` / ``sanitize_tree``): a pass over every
  memory-pool leaf on its own device, run at each ``ckpt_every`` boundary
  and after restore.  It flags chunks holding non-finite or overflow-scale
  (``> MAX_ABS``) values, the two signatures storage bit-rot leaves on f32
  data, and quarantines them: zeroed whole, in place, because under LMA's
  shared memory a zero row degrades the model gracefully while a rotten row
  destroys it.  A clean leaf is not written.

* **At-rest checksums** (``chunk_checksums`` / ``np_chunk_checksums``): an
  order-independent uint32 sum of the raw bits of each ``CHUNK``-element
  chunk, recorded in the checkpoint manifest at save and re-verified at
  restore.  PyTorch's CPU uint32 has no arithmetic, so the device version
  sums the int32 bit patterns in int64 and keeps the low 32 bits: the
  wraparound uint32 sum, bit-equal to the numpy twin on either device.

The numpy twins are copies of the reference's; the checkpoint manager uses
them on host snapshots.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 8192       # elements per integrity chunk (32 KiB of f32)
MAX_ABS = 1e30     # |x| beyond this is corruption, not training signal


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Flat int32 bit patterns of ``x`` (a view for f32 / int32 / uint32;
    other widths go through f32, deterministic but not bit-faithful, as in
    the reference)."""
    flat = x.detach().reshape(-1)
    if flat.dtype in (torch.float32, torch.int32, torch.uint32):
        return flat.view(torch.int32)
    return flat.to(torch.float32).view(torch.int32)


def _chunked(flat: torch.Tensor, chunk: int):
    """-> (full chunks as a [n_full, chunk] view, the partial tail)."""
    full = flat.numel() // chunk
    return flat[: full * chunk].view(full, chunk), flat[full * chunk:]


def n_chunks(size: int, chunk: int = CHUNK) -> int:
    return -(-size // chunk)


def chunk_checksums(x: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """[n_chunks] int64 holding the uint32 wraparound bit sum of each chunk
    (a partial last chunk is zero-padded: zeros add nothing)."""
    body, tail = _chunked(_bits(x), chunk)
    out = [torch.sum(body, dim=1, dtype=torch.int64)]
    if tail.numel():
        out.append(torch.sum(tail, dtype=torch.int64)[None])
    return torch.cat(out) & 0xFFFFFFFF


def np_chunk_checksums(a: np.ndarray, chunk: int = CHUNK) -> np.ndarray:
    """Host twin of :func:`chunk_checksums`, bit-equal on f32/int32 input."""
    flat = np.ascontiguousarray(a).reshape(-1)
    if flat.dtype == np.float32:
        bits = flat.view(np.uint32)
    elif flat.dtype in (np.int32, np.uint32):
        bits = flat.astype(np.uint32)
    else:
        bits = flat.astype(np.float32).view(np.uint32)
    n = -(-bits.size // chunk)
    pad = n * chunk - bits.size
    if pad:
        bits = np.concatenate([bits, np.zeros((pad,), np.uint32)])
    return bits.reshape(n, chunk).sum(axis=1, dtype=np.uint32)


def bad_value_chunks(x: torch.Tensor, chunk: int = CHUNK,
                     max_abs: float = MAX_ABS) -> torch.Tensor:
    """[n_chunks] bool: the chunk holds a non-finite or overflow-scale value
    (``!(|v| <= max_abs)`` is true for NaN, inf and overflow alike)."""
    flat = x.detach().reshape(-1)
    if not flat.is_floating_point():
        return torch.zeros(n_chunks(flat.numel(), chunk), dtype=torch.bool,
                           device=flat.device)
    body, tail = _chunked(flat, chunk)
    out = [torch.logical_not(torch.all(body.abs() <= max_abs, dim=1))]
    if tail.numel():
        out.append(torch.logical_not(torch.all(tail.abs() <= max_abs))[None])
    return torch.cat(out)


@torch.no_grad()
def quarantine_chunks(x: torch.Tensor, bad: torch.Tensor,
                      chunk: int = CHUNK) -> torch.Tensor:
    """Zero every flagged chunk of ``x`` in place; -> ``x``."""
    body, tail = _chunked(x.detach().view(-1), chunk)
    body[bad[: body.shape[0]]] = 0
    if tail.numel() and bool(bad[-1]):
        tail.zero_()
    return x


def np_quarantine_chunks(a: np.ndarray, bad: np.ndarray,
                         chunk: int = CHUNK) -> np.ndarray:
    out = np.ascontiguousarray(a).reshape(-1).copy()
    for i in np.nonzero(bad)[0]:
        out[i * chunk: (i + 1) * chunk] = 0
    return out[: a.size].reshape(a.shape)


def np_bad_value_chunks(a: np.ndarray, chunk: int = CHUNK,
                        max_abs: float = MAX_ABS) -> np.ndarray:
    """Host twin of :func:`bad_value_chunks` -- same flags, same chunking."""
    flat = np.ascontiguousarray(a).reshape(-1)
    if not np.issubdtype(flat.dtype, np.floating):
        return np.zeros((-(-flat.size // chunk),), bool)
    n = -(-flat.size // chunk)
    pad = n * chunk - flat.size
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    c = flat.reshape(n, chunk)
    with np.errstate(invalid="ignore"):
        bad = ~np.isfinite(c) | (np.abs(c) > max_abs)
    return np.any(bad, axis=1)


def np_sanitize(a: np.ndarray, chunk: int = CHUNK,
                max_abs: float = MAX_ABS) -> tuple[np.ndarray, int]:
    """Host twin of :func:`sanitize`. -> (clean copy, n_bad)."""
    bad = np_bad_value_chunks(a, chunk, max_abs)
    n = int(bad.sum())
    if not n:
        return a, 0
    return np_quarantine_chunks(a, bad, chunk), n


def sanitize(x: torch.Tensor, chunk: int = CHUNK,
             max_abs: float = MAX_ABS) -> tuple[torch.Tensor, int]:
    """Scan ``x`` and zero its bad chunks in place. -> (x, n_bad_chunks)."""
    bad = bad_value_chunks(x, chunk, max_abs)
    n_bad = int(bad.sum())
    if n_bad:
        quarantine_chunks(x, bad, chunk)
    return x, n_bad


def is_memory(path: str) -> bool:
    """A leaf whose path (components split on '/' or '.') names a memory
    pool: ``embedding.memory``, ``opt_state/#1/embedding/memory``."""
    return "memory" in path.replace(".", "/").split("/")


def memory_leaves(tree, prefix: str = ""):
    """-> [(path, tensor)] for every floating tensor under a memory path of
    ``tree`` (dicts keyed by dotted names, tuples, NamedTuples)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in memory_leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in memory_leaves(v, f"{prefix}/#{i}")]
    if (isinstance(tree, torch.Tensor) and tree.is_floating_point()
            and is_memory(prefix)):
        return [(prefix.lstrip("/"), tree)]
    return []


def sanitize_tree(tree, chunk: int = CHUNK, max_abs: float = MAX_ABS):
    """Scan and quarantine, in place, every memory-pool leaf of ``tree``.
    -> (tree, n_bad)."""
    total = 0
    for _, x in memory_leaves(tree):
        total += sanitize(x, chunk, max_abs)[1]
    return tree, total
