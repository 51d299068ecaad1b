"""Evaluation metrics: exact ROC-AUC, logloss, accuracy (numpy copy of
``repro.data.metrics``)."""
from __future__ import annotations

import numpy as np


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact AUC via the rank statistic (Mann-Whitney U), ties handled."""
    labels = np.asarray(labels).ravel().astype(np.float64)
    scores = np.asarray(scores).ravel().astype(np.float64)
    n_pos = float(labels.sum())
    n_neg = float(len(labels) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    # average ranks for ties
    i = 0
    r = 1.0
    N = len(scores)
    while i < N:
        j = i
        while j + 1 < N and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i : j + 1]] = avg
        r += j - i + 1
        i = j + 1
    sum_pos = ranks[labels == 1].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def logloss(labels: np.ndarray, probs: np.ndarray, eps: float = 1e-7) -> float:
    labels = np.asarray(labels).ravel()
    p = np.clip(np.asarray(probs).ravel(), eps, 1 - eps)
    return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))


def accuracy(labels: np.ndarray, probs: np.ndarray) -> float:
    labels = np.asarray(labels).ravel()
    return float(np.mean((np.asarray(probs).ravel() > 0.5) == (labels > 0.5)))


class StreamingEval:
    """Accumulate (label, score) pairs across eval batches, then compute all."""

    def __init__(self):
        self.labels: list[np.ndarray] = []
        self.scores: list[np.ndarray] = []

    def add(self, labels, scores):
        self.labels.append(np.asarray(labels).ravel())
        self.scores.append(np.asarray(scores).ravel())

    def compute(self) -> dict:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        p = 1.0 / (1.0 + np.exp(-s))
        return {"auc": roc_auc(y, s), "logloss": logloss(y, p),
                "accuracy": accuracy(y, p), "n": int(len(y))}
