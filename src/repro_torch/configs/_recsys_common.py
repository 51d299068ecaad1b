"""Shared pieces for the recsys architecture configs (copy of
``repro.configs._recsys_common``).

Criteo-Kaggle per-field vocabulary sizes (the standard 26-field list, 33.76M
values in all), field 0 the largest.
"""
from __future__ import annotations

from repro_torch.embed import EmbeddingConfig, get_scheme

CRITEO_VOCABS = (
    10131227, 1460, 583, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)  # sum = 33,762,577

RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

RECSYS_SHAPE_TABLE = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}


def matched_budget(vocab_sizes: tuple[int, ...], dim: int,
                   expansion: float) -> int:
    """Scalar budget m at compression alpha, rounded up to a multiple of
    4096."""
    total = sum(vocab_sizes)
    m = max(int(total * dim / expansion), 4096)
    return -(-m // 4096) * 4096


def embedding_of_kind(kind: str, vocab_sizes: tuple[int, ...], dim: int,
                      expansion: float = 16.0, **kw) -> EmbeddingConfig:
    """Any registered scheme at a matched budget."""
    budget = matched_budget(vocab_sizes, dim, expansion)
    return get_scheme(kind).build_config(tuple(vocab_sizes), dim, budget,
                                         **kw)


def smoke_vocabs(n_fields: int) -> tuple[int, ...]:
    return tuple([97 + 13 * (i % 5) for i in range(n_fields)])
