"""din [recsys] embed_dim=18, seq_len=100, attn_mlp=80-40, mlp=200-80,
target-attention interaction.  [arXiv:1706.06978; paper]
(port of ``repro.configs.din``)

Item vocabulary 5M (Alibaba-scale); the history is an id sequence over the
item table, so the LMA common memory serves both history and candidate
lookups.  Default embedding: LMA at alpha=16 (5M x 18 -> a 5,627,904-slot
pool, flat: 5,627,904 % 18 != 0).
"""
from repro_torch.configs._recsys_common import RECSYS_SHAPES, embedding_of_kind
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.recsys import RecsysConfig

DIN_VOCABS = (5_000_000,)


def make_model(shape_id=None, embedding_kind: str = "lma"):
    return RecsysConfig(
        name="din", model="din",
        embedding=embedding_of_kind(embedding_kind, DIN_VOCABS, 18),
        n_dense=0, hist_len=100, attn_mlp=(80, 40), top_mlp=(200, 80))


def make_smoke(embedding_kind: str = "lma"):
    return RecsysConfig(
        name="din-smoke", model="din",
        embedding=embedding_of_kind(embedding_kind, (5000,), 18,
                                    expansion=8.0, max_set=16),
        n_dense=0, hist_len=20, attn_mlp=(20, 10), top_mlp=(32, 16))


register(ArchConfig(
    arch_id="din", family="recsys", make_model=make_model,
    make_smoke=make_smoke, shapes=RECSYS_SHAPES, optimizer="adagrad",
    learning_rate=1e-2, source="arXiv:1706.06978"))
