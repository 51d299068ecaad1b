"""Synthetic CTR data with *planted semantic structure* (numpy copy of
``repro.data.synthetic_ctr``: the same spec and seed give the same batches
in both packages, the DIN generator's too).

The real Criteo (46M rows) / Avazu (41M rows) datasets are not part of the
repository, so mechanism validation uses a generator whose categorical
values carry genuine semantics:

  * each sample has a latent intent ``z ~ Cat(K)``;
  * every field's vocabulary is partitioned into K clusters; with probability
    ``p_signal`` the sample's value for a field is drawn from cluster ``z``
    (long-tail Zipf within the cluster), otherwise uniformly at random;
  * the label is a logistic function of intent-cluster agreements across fields
    plus dense-feature signal.

Consequences (exactly what LMA exploits): values of the same cluster co-occur
in the same samples => high Jaccard on their D_v sets => LMA shares their
memory; values that the model must distinguish live in different clusters =>
near-zero Jaccard => LMA separates them.  A budget-constrained hashing trick
collides values *uniformly*, destroying exactly this structure — so the paper's
qualitative claim (LMA > hashing trick at equal budget, approaching full) is
testable here.  Schema defaults match Criteo (13 dense + 26 categorical).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CTRSpec:
    n_fields: int = 26
    n_dense: int = 13
    vocab_sizes: tuple[int, ...] = ()
    n_clusters: int = 24
    p_signal: float = 0.8
    label_noise: float = 0.15
    # within-cluster value popularity: "geometric" (head-heavy, ~10 hot values
    # per cluster) or "uniform" (flat — the whole vocabulary is live, which is
    # the regime where budget collisions actually bite, like Criteo's tens of
    # millions of active values)
    value_dist: str = "geometric"
    seed: int = 0

    def __post_init__(self):
        if not self.vocab_sizes:
            rng = np.random.default_rng(self.seed + 999)
            sizes = rng.integers(200, 2000, self.n_fields)
            object.__setattr__(self, "vocab_sizes", tuple(int(s) for s in sizes))

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))


class CTRGenerator:
    """Deterministic, seekable batch generator (host-side numpy)."""

    def __init__(self, spec: CTRSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        K = spec.n_clusters
        # per-field cluster assignment of each value (contiguous blocks + shuffle)
        self.value_cluster = []
        for f, v in enumerate(spec.vocab_sizes):
            assign = np.arange(v) % K
            rng.shuffle(assign)
            self.value_cluster.append(assign)
        # label model: weight per (field, cluster) + dense weights
        self.w_fc = rng.normal(0, 1.0, (spec.n_fields, K))
        self.w_dense = rng.normal(0, 0.5, spec.n_dense)
        self.dense_mu = rng.normal(0, 1.0, (K, spec.n_dense))
        # per-field per-cluster value lists for sampling
        self.cluster_values = []
        for f in range(spec.n_fields):
            lists = [np.where(self.value_cluster[f] == c)[0] for c in range(K)]
            self.cluster_values.append(lists)
        self.offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(spec.vocab_sizes, np.int64))])

    def batch(self, batch_size: int, batch_idx: int) -> dict:
        """Returns {dense [B,nd] f32, sparse [B,F] i32 (field-local), label [B] f32}."""
        spec = self.spec
        rng = np.random.default_rng((spec.seed, batch_idx, 0xC7))
        K = spec.n_clusters
        z = rng.integers(0, K, batch_size)
        sparse = np.empty((batch_size, spec.n_fields), np.int32)
        logits = np.zeros(batch_size)
        for f in range(spec.n_fields):
            signal = rng.random(batch_size) < spec.p_signal
            clusters = np.where(signal, z, rng.integers(0, K, batch_size))
            vals = np.empty(batch_size, np.int64)
            for c in np.unique(clusters):
                idx = np.where(clusters == c)[0]
                pool = self.cluster_values[f][c]
                if spec.value_dist == "uniform":
                    ranks = rng.integers(0, len(pool), len(idx))
                else:
                    # Zipf-ish within cluster: geometric rank sampling
                    ranks = np.minimum(
                        rng.geometric(p=min(8.0 / max(len(pool), 1), 0.9),
                                      size=len(idx)) - 1,
                        len(pool) - 1)
                vals[idx] = pool[ranks]
            sparse[:, f] = vals
            logits += self.w_fc[f, self.value_cluster[f][vals]]
        dense = (self.dense_mu[z]
                 + rng.normal(0, 1.0, (batch_size, spec.n_dense))).astype(np.float32)
        logits = logits / np.sqrt(spec.n_fields) + dense @ self.w_dense
        logits = (logits - logits.mean()) / max(logits.std(), 1e-6) * 2.0
        prob = 1.0 / (1.0 + np.exp(-logits))
        label = (rng.random(batch_size) < np.where(
            rng.random(batch_size) < spec.label_noise,
            0.5, prob)).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "label": label}

    def rows_for_signatures(self, n_rows: int, batch_size: int = 4096):
        """Yield rows of *global* value ids — input to build_signature_store."""
        done = 0
        bidx = 10_000_000  # disjoint stream from training batches
        while done < n_rows:
            b = self.batch(min(batch_size, n_rows - done), bidx)
            g = b["sparse"].astype(np.int64) + self.offsets[:-1][None, :]
            for row in g:
                yield row
            done += b["sparse"].shape[0]
            bidx += 1


@dataclasses.dataclass(frozen=True)
class DINSpec:
    """Sequence-behaviour CTR (DIN): history of item ids + candidate item."""

    n_items: int = 50_000
    n_clusters: int = 100
    hist_len: int = 100
    p_signal: float = 0.8
    seed: int = 0


class DINGenerator:
    """Deterministic, seekable DIN batches: each sample's history is drawn
    mostly from its intent cluster, and the label says whether the
    candidate shares that cluster (10% flipped)."""

    def __init__(self, spec: DINSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        assign = np.arange(spec.n_items) % spec.n_clusters
        rng.shuffle(assign)
        self.item_cluster = assign
        self.cluster_items = [np.where(assign == c)[0]
                              for c in range(spec.n_clusters)]

    def batch(self, batch_size: int, batch_idx: int) -> dict:
        """-> {hist [B, L] i32, hist_mask [B, L] bool, target [B] i32,
        label [B] f32}."""
        spec = self.spec
        rng = np.random.default_rng((spec.seed, batch_idx, 0xD1))
        K = spec.n_clusters
        z = rng.integers(0, K, batch_size)
        L = spec.hist_len
        hist = np.empty((batch_size, L), np.int32)
        for i in range(batch_size):
            own = rng.random(L) < spec.p_signal
            cs = np.where(own, z[i], rng.integers(0, K, L))
            hist[i] = [rng.choice(self.cluster_items[c]) for c in cs]
        lengths = rng.integers(L // 4, L + 1, batch_size)
        mask = np.arange(L)[None, :] < lengths[:, None]
        # candidate: positive = same intent cluster, negative = random
        pos = rng.random(batch_size) < 0.5
        tgt_c = np.where(pos, z, rng.integers(0, K, batch_size))
        target = np.array([rng.choice(self.cluster_items[c]) for c in tgt_c],
                          np.int32)
        label = (self.item_cluster[target] == z).astype(np.float32)
        flip = rng.random(batch_size) < 0.1
        label = np.where(flip, 1 - label, label)
        return {"hist": hist, "hist_mask": mask, "target": target,
                "label": label}

    def rows_for_signatures(self, n_rows: int):
        """Yield each sample's distinct history items (its D' row)."""
        done, bidx = 0, 20_000_000
        while done < n_rows:
            b = self.batch(min(1024, n_rows - done), bidx)
            for i in range(b["hist"].shape[0]):
                items = b["hist"][i][b["hist_mask"][i]]
                yield np.unique(items)
            done += b["hist"].shape[0]
            bidx += 1
