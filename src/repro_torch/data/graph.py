"""Graph data (numpy copy of ``repro.data.graph``): SBM synthetic graphs
(Cora/products-shaped), neighbor sampling, molecule batching.

``minibatch_lg`` needs a real neighbor sampler: ``NeighborSampler`` builds a
CSR adjacency once and draws fanout-limited k-hop blocks (GraphSAGE-style),
whose edge lists ``pad_block`` pads to fixed shapes.  Every array is
bit-identical to the reference's for the same seed.  Two host hot spots
are computed another way with the same bits: the CSR row counts by
``np.bincount`` (the reference's ``np.add.at``), and a block's local ids by
``np.searchsorted`` over its sorted, unique nodes (the reference's per-id
dict); the sampler's draws keep their order, one ``rng.choice`` per
frontier node.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    src: np.ndarray          # [E] int32
    dst: np.ndarray          # [E] int32
    features: np.ndarray     # [N, F] float32
    labels: np.ndarray       # [N] int32
    n_nodes: int
    train_mask: np.ndarray | None = None


def sbm_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
              seed: int = 0, homophily: float = 0.8) -> Graph:
    """Stochastic-block-model graph with class-correlated features
    (Cora-like): ``n_edges`` drawn edges, symmetrised, and a self loop a
    node (2 * n_edges + n_nodes edges)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    # sample edges: with prob homophily endpoints share a class
    same = rng.random(n_edges) < homophily
    src = rng.integers(0, n_nodes, n_edges)
    # same-class partner: redraw the mismatches up to 4 times, then any
    dst = rng.integers(0, n_nodes, n_edges)
    for _ in range(4):
        bad = same & (labels[dst] != labels[src])
        if not bad.any():
            break
        dst[bad] = rng.integers(0, n_nodes, bad.sum())
    # add self loops + symmetrize
    src, dst = (np.concatenate([src, dst, np.arange(n_nodes)]),
                np.concatenate([dst, src, np.arange(n_nodes)]))
    class_proto = rng.normal(0, 1.0, (n_classes, d_feat))
    features = (class_proto[labels] + rng.normal(0, 1.2, (n_nodes, d_feat))
                ).astype(np.float32)
    train_mask = rng.random(n_nodes) < 0.3
    return Graph(src.astype(np.int32), dst.astype(np.int32), features, labels,
                 n_nodes, train_mask)


class NeighborSampler:
    """Fanout-limited k-hop block sampler over a CSR adjacency."""

    def __init__(self, graph: Graph, fanouts: tuple[int, ...], seed: int = 0):
        self.graph = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)
        order = np.argsort(graph.dst, kind="stable")
        self.in_src = graph.src[order]            # incoming neighbors per node
        self.indptr = np.zeros(graph.n_nodes + 1, np.int64)
        self.indptr[1:] = np.bincount(graph.dst, minlength=graph.n_nodes)
        np.cumsum(self.indptr, out=self.indptr)

    def sample(self, batch_nodes: np.ndarray) -> dict:
        """A block subgraph: local-id edge list covering k hops, with a self
        loop a node (``pad_block`` pads it to fixed shapes)."""
        layers = [np.asarray(batch_nodes, np.int64)]
        edges_src, edges_dst = [], []
        frontier = layers[0]
        for fan in self.fanouts:
            nbr_src, nbr_dst = [], []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(fan, deg)
                sel = self.rng.choice(deg, take, replace=False) + lo
                nbr_src.append(self.in_src[sel])
                nbr_dst.append(np.full(take, v, np.int64))
            if nbr_src:
                edges_src.append(np.concatenate(nbr_src))
                edges_dst.append(np.concatenate(nbr_dst))
                frontier = np.unique(edges_src[-1])
            else:
                frontier = np.empty(0, np.int64)
            layers.append(frontier)
        all_src = (np.concatenate(edges_src) if edges_src
                   else np.empty(0, np.int64))
        all_dst = (np.concatenate(edges_dst) if edges_dst
                   else np.empty(0, np.int64))
        nodes = np.unique(np.concatenate([np.concatenate(layers), all_src,
                                          all_dst]))
        # nodes is sorted and unique: a global id's local id is its rank
        lsrc = np.searchsorted(nodes, all_src).astype(np.int32)
        ldst = np.searchsorted(nodes, all_dst).astype(np.int32)
        # self loops keep isolated batch nodes alive
        loops = np.arange(len(nodes), dtype=np.int32)
        g = self.graph
        return {
            "src": np.concatenate([lsrc, loops]),
            "dst": np.concatenate([ldst, loops]),
            "features": g.features[nodes],
            "labels": g.labels[nodes],
            "label_mask": np.isin(nodes, batch_nodes),
            "n_nodes": len(nodes),
        }


def pad_block(block: dict, max_nodes: int, max_edges: int) -> dict:
    """Pad a sampled block to fixed shapes: padded edges are self loops on
    the last (padded, masked-out) node."""
    n, e = block["n_nodes"], len(block["src"])
    if n > max_nodes or e > max_edges:
        raise ValueError(f"block of {n} nodes and {e} edges exceeds "
                         f"{max_nodes} nodes and {max_edges} edges")
    out = dict(block)
    out["src"] = np.concatenate(
        [block["src"], np.zeros(max_edges - e, np.int32)])
    out["dst"] = np.concatenate(
        [block["dst"], np.full(max_edges - e, max_nodes - 1, np.int32)])
    out["features"] = np.pad(block["features"],
                             ((0, max_nodes - n), (0, 0)))
    out["labels"] = np.pad(block["labels"], (0, max_nodes - n))
    out["label_mask"] = np.pad(block["label_mask"], (0, max_nodes - n))
    return out


def molecule_batch(batch_size: int, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int, seed: int = 0) -> dict:
    """Batched small graphs: block-diagonal edge list + graph ids for
    readout."""
    rng = np.random.default_rng(seed)
    srcs, dsts, gids = [], [], []
    for b in range(batch_size):
        s = rng.integers(0, n_nodes, n_edges) + b * n_nodes
        d = rng.integers(0, n_nodes, n_edges) + b * n_nodes
        loops = np.arange(n_nodes) + b * n_nodes
        srcs.append(np.concatenate([s, d, loops]))
        dsts.append(np.concatenate([d, s, loops]))
        gids.append(np.full(n_nodes, b))
    N = batch_size * n_nodes
    labels = rng.integers(0, n_classes, batch_size).astype(np.int32)
    feats = rng.normal(0, 1, (N, d_feat)).astype(np.float32)
    # plant signal: add label prototype to each graph's features
    proto = rng.normal(0, 1, (n_classes, d_feat))
    for b in range(batch_size):
        feats[b * n_nodes : (b + 1) * n_nodes] += proto[labels[b]]
    return {
        "src": np.concatenate(srcs).astype(np.int32),
        "dst": np.concatenate(dsts).astype(np.int32),
        "features": feats,
        "graph_ids": np.concatenate(gids).astype(np.int32),
        "n_graphs": batch_size,
        "labels": labels,
    }
