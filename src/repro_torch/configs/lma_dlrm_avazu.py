"""The paper's LMA-DLRM on Avazu-shaped data: 21 categorical fields and one
dense feature, the hour of day (paper Table 1: 21 categorical + 0 integer
fields, 9.45M values), at the bench-scale vocabularies of
``repro.configs.lma_dlrm_avazu`` (port)."""
from repro_torch.configs._recsys_common import embedding_of_kind
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.recsys import RecsysConfig

BENCH_VOCABS = tuple(150 + (i * 917) % 3100 for i in range(21))


def make_model(shape_id=None, embedding_kind: str = "lma",
               expansion: float = 16.0, n_h: int = 4):
    return RecsysConfig(
        name="lma-dlrm-avazu", model="dlrm",
        embedding=embedding_of_kind(embedding_kind, BENCH_VOCABS, 32,
                                    expansion=expansion, n_h=n_h, max_set=32),
        n_dense=1,  # hour-of-day numeric
        bot_mlp=(64, 32), top_mlp=(256, 128, 1))


def make_smoke(embedding_kind: str = "lma"):
    return make_model(embedding_kind=embedding_kind, expansion=8.0)


register(ArchConfig(
    arch_id="lma-dlrm-avazu", family="recsys", make_model=make_model,
    make_smoke=make_smoke,
    shapes=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"),
    optimizer="adagrad", learning_rate=1e-2,
    source="this paper, section 7 (Avazu setup)"))
