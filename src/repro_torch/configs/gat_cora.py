"""gat-cora [gnn] 2 layers, d_hidden=8, 8 heads, attention aggregator.
[arXiv:1710.10903; paper] (copy of ``repro.configs.gat_cora``).

The GAT architecture is fixed; each assigned shape carries its own graph stats
(d_feat, n_classes differ per dataset):
  full_graph_sm : Cora         N=2,708     E=10,556      d_feat=1,433, 7 cls
  minibatch_lg  : Reddit-like  N=232,965   E=114,615,892 d_feat=602,  41 cls
                  (sampled: batch_nodes=1,024, fanout 15-10)
  ogb_products  : ogbn-products N=2,449,029 E=61,859,140 d_feat=100,  47 cls
  molecule      : 128 graphs x 30 nodes / 64 edges, d_feat=32, 10 cls, mean
                  readout

E counts drawn edges: ``sbm_graph`` symmetrises them and adds a self loop a
node (2 E + N edges in all).  The shapes carry dense features, so no
embedding table is built; ``GATConfig.node_id_embedding`` draws node inputs
from an ``EmbeddingTable`` instead (the id-feature path).
"""
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.gnn import GATConfig

GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")

GNN_SHAPE_TABLE = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7, kind="full_graph"),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                         n_classes=41, batch_nodes=1024, fanout=(15, 10),
                         kind="minibatch"),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         n_classes=47, kind="full_graph"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=32,
                     n_classes=10, kind="batched_graphs"),
}


def make_model(shape_id=None):
    t = GNN_SHAPE_TABLE[shape_id or "full_graph_sm"]
    return GATConfig(
        d_in=t["d_feat"], n_layers=2, d_hidden=8, n_heads=8,
        n_classes=t["n_classes"],
        readout="mean" if t["kind"] == "batched_graphs" else None)


def make_smoke():
    return GATConfig(d_in=16, n_layers=2, d_hidden=8, n_heads=4, n_classes=5)


register(ArchConfig(
    arch_id="gat-cora", family="gnn", make_model=make_model,
    make_smoke=make_smoke, shapes=GNN_SHAPES, optimizer="adam",
    learning_rate=5e-3, source="arXiv:1710.10903"))
