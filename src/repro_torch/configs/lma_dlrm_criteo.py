"""The paper's own system: LMA-DLRM on Criteo-shaped data (paper section 7),
at the laptop scale of ``repro.configs.lma_dlrm_criteo`` (port)."""
from repro_torch.configs._recsys_common import embedding_of_kind
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.recsys import RecsysConfig

# bench-scale vocabularies: 26 fields, ~52K values total
BENCH_VOCABS = tuple(200 + (i * 731) % 3800 for i in range(26))


def make_model(shape_id=None, embedding_kind: str = "lma",
               expansion: float = 16.0, n_h: int = 4):
    return RecsysConfig(
        name="lma-dlrm-criteo", model="dlrm",
        embedding=embedding_of_kind(embedding_kind, BENCH_VOCABS, 32,
                                    expansion=expansion, n_h=n_h, max_set=32),
        n_dense=13, bot_mlp=(128, 64, 32), top_mlp=(256, 128, 1))


def make_smoke(embedding_kind: str = "lma"):
    return make_model(embedding_kind=embedding_kind, expansion=8.0)


register(ArchConfig(
    arch_id="lma-dlrm-criteo", family="recsys", make_model=make_model,
    make_smoke=make_smoke,
    shapes=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"),
    optimizer="adagrad", learning_rate=1e-2,
    source="this paper, section 7 (Criteo setup)"))
