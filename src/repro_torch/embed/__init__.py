"""repro_torch.embed — the embedding subsystem (port of ``repro.embed``).

:class:`Scheme` is the allocation policy (full | hashed_elem | hashed_row |
qr | lma | md | freq, ``list_schemes``); the backend is the plain split
version for a CPU pool or a scheme without a fused spec (freq), the fused
CUDA kernel for a CUDA pool, the sharded lookup under a mesh, the tiered
lookup when the buffers carry a tier's remap state.  Models hold an
:class:`EmbeddingTable` and call ``init`` / ``embed`` / ``embed_fields`` /
``embed_bag``.
"""
from repro_torch.embed.backends import (FUSED, SPLIT, TIERED, FusedBackend,
                                        SplitBackend, TieredBackend,
                                        resolve_backend)
from repro_torch.embed.config import EmbeddingConfig, table_offsets
from repro_torch.embed.registry import (Scheme, get_scheme, list_schemes,
                                        register_scheme)
from repro_torch.embed.table import (EmbeddingTable, embed, embed_bag,
                                     embed_fields, init_embedding,
                                     make_buffers, materialize_rows)

__all__ = [
    "EmbeddingConfig", "EmbeddingTable", "FUSED", "FusedBackend", "SPLIT",
    "Scheme", "SplitBackend", "TIERED", "TieredBackend", "embed", "embed_bag", "embed_fields",
    "get_scheme", "init_embedding", "list_schemes", "make_buffers",
    "materialize_rows",
    "register_scheme", "resolve_backend", "table_offsets",
]
