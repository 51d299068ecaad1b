"""xdeepfm [recsys] 39 sparse fields, embed_dim=10, CIN 200-200-200,
mlp=400-400, CIN interaction.  [arXiv:1803.05170; paper]
(port of ``repro.configs.xdeepfm``)

Default embedding: LMA at alpha=16 over the 39 Criteo fields (33,763,877
values x 10 -> a 21,102,592-slot pool, flat: 21,102,592 % 10 != 0), plus the
first-order linear table, a second d=1 pool of 2,113,536 slots.
"""
from repro_torch.configs._recsys_common import (RECSYS_SHAPES, XDEEPFM_VOCABS,
                                                embedding_of_kind,
                                                smoke_vocabs)
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.recsys import RecsysConfig


def make_model(shape_id=None, embedding_kind: str = "lma"):
    return RecsysConfig(
        name="xdeepfm", model="xdeepfm",
        embedding=embedding_of_kind(embedding_kind, XDEEPFM_VOCABS, 10),
        n_dense=0, cin_layers=(200, 200, 200), deep_mlp=(400, 400))


def make_smoke(embedding_kind: str = "lma"):
    return RecsysConfig(
        name="xdeepfm-smoke", model="xdeepfm",
        embedding=embedding_of_kind(embedding_kind, smoke_vocabs(12), 8,
                                    expansion=8.0, max_set=16),
        n_dense=0, cin_layers=(24, 24), deep_mlp=(32, 32))


register(ArchConfig(
    arch_id="xdeepfm", family="recsys", make_model=make_model,
    make_smoke=make_smoke, shapes=RECSYS_SHAPES, optimizer="adagrad",
    learning_rate=1e-2, source="arXiv:1803.05170"))
