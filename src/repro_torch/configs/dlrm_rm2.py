"""dlrm-rm2 [recsys] 13 dense + 26 sparse, embed_dim=64,
bot_mlp=13-512-256-64, top_mlp=415-512-512-256-1, dot interaction.
[arXiv:1906.00091; paper]  (port of ``repro.configs.dlrm_rm2``)

Default embedding: LMA at the paper's alpha=16 over the Criteo vocabularies
(33.76M values x 64 -> a 135,053,312-slot pool, striped).
"""
from repro_torch.configs._recsys_common import (CRITEO_VOCABS, RECSYS_SHAPES,
                                                embedding_of_kind,
                                                smoke_vocabs)
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.recsys import RecsysConfig


def make_model(shape_id=None, embedding_kind: str = "lma"):
    return RecsysConfig(
        name="dlrm-rm2", model="dlrm",
        embedding=embedding_of_kind(embedding_kind, CRITEO_VOCABS, 64),
        n_dense=13, bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))


def make_smoke(embedding_kind: str = "lma"):
    return RecsysConfig(
        name="dlrm-rm2-smoke", model="dlrm",
        embedding=embedding_of_kind(embedding_kind, smoke_vocabs(26), 16,
                                    expansion=8.0, max_set=16),
        n_dense=13, bot_mlp=(32, 16), top_mlp=(64, 32, 1))


register(ArchConfig(
    arch_id="dlrm-rm2", family="recsys", make_model=make_model,
    make_smoke=make_smoke, shapes=RECSYS_SHAPES, optimizer="adagrad",
    learning_rate=1e-2, source="arXiv:1906.00091"))
