"""repro_torch.embed — the embedding subsystem (port of ``repro.embed``).

:class:`Scheme` is the allocation policy (full | hashed_elem | hashed_row |
lma in this slice); the backend is the plain split version for a CPU pool
or the fused CUDA kernel for a CUDA pool.  Models hold an
:class:`EmbeddingTable` and call ``init`` / ``embed`` / ``embed_fields`` /
``embed_bag``.
"""
from repro_torch.embed.backends import (FUSED, SPLIT, FusedBackend,
                                        SplitBackend, resolve_backend)
from repro_torch.embed.config import EmbeddingConfig, table_offsets
from repro_torch.embed.registry import Scheme, get_scheme, register_scheme
from repro_torch.embed.table import (EmbeddingTable, embed, embed_bag,
                                     embed_fields, init_embedding,
                                     make_buffers)

__all__ = [
    "EmbeddingConfig", "EmbeddingTable", "FUSED", "FusedBackend", "SPLIT",
    "Scheme", "SplitBackend", "embed", "embed_bag", "embed_fields",
    "get_scheme", "init_embedding", "make_buffers",
    "register_scheme", "resolve_backend", "table_offsets",
]
