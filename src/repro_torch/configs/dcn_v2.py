"""dcn-v2 [recsys] 13 dense + 26 sparse, embed_dim=16, 3 cross layers,
mlp=1024-1024-512, cross interaction.  [arXiv:2008.13535; paper]
(port of ``repro.configs.dcn_v2``)

Default embedding: LMA at alpha=16 over the Criteo vocabularies (33.76M
values x 16 -> a 33,763,328-slot pool, striped: 2,110,208 a stripe); x0 is
26 x 16 + 13 = 429 wide.
"""
from repro_torch.configs._recsys_common import (CRITEO_VOCABS, RECSYS_SHAPES,
                                                embedding_of_kind,
                                                smoke_vocabs)
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.recsys import RecsysConfig


def make_model(shape_id=None, embedding_kind: str = "lma"):
    return RecsysConfig(
        name="dcn-v2", model="dcn",
        embedding=embedding_of_kind(embedding_kind, CRITEO_VOCABS, 16),
        n_dense=13, n_cross_layers=3, deep_mlp=(1024, 1024, 512))


def make_smoke(embedding_kind: str = "lma"):
    return RecsysConfig(
        name="dcn-v2-smoke", model="dcn",
        embedding=embedding_of_kind(embedding_kind, smoke_vocabs(26), 8,
                                    expansion=8.0, max_set=16),
        n_dense=13, n_cross_layers=2, deep_mlp=(64, 32))


register(ArchConfig(
    arch_id="dcn-v2", family="recsys", make_model=make_model,
    make_smoke=make_smoke, shapes=RECSYS_SHAPES, optimizer="adagrad",
    learning_rate=1e-2, source="arXiv:2008.13535"))
