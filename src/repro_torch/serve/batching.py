"""Request batching for online serving (the serve_p99 path).

A copy of ``repro.serve.batching`` (numpy only; each request also records
when its result was set, for latency) plus ``model_score_fn``,
which turns a port model into the scorer's score function: it receives the
padded numpy batch, moves it to the model's device and scores it there.

Requests queue up; a batch is cut when ``max_batch`` requests are waiting or
the oldest has waited ``max_delay_ms``; batches are padded to power-of-two
buckets; responses are futures keyed by request id.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch


def pad_buckets(max_batch: int) -> tuple[int, ...]:
    """Power-of-two bucket ladder: 1, 2, 4, ... max_batch."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class _Pending:
    req_id: int
    features: dict           # single-example feature dict (numpy)
    t_enqueue: float
    event: threading.Event
    result: Optional[float] = None
    error: Optional[BaseException] = None   # score_fn failure, re-raised in score()
    t_done: Optional[float] = None          # when the result was set


class BatchingScorer:
    """Batches single-example requests into padded device calls.

    ``score_fn(batch_dict) -> scores [B]`` must accept numpy arrays whose
    leading dim is one of the pad buckets.
    """

    def __init__(self, score_fn: Callable[[dict], np.ndarray],
                 max_batch: int = 512, max_delay_ms: float = 2.0):
        self.score_fn = score_fn
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.buckets = pad_buckets(max_batch)
        self._queue: deque[_Pending] = deque()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._stop = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self.n_batches = 0
        self.n_requests = 0
        self.batch_sizes: list[int] = []
        self._worker.start()

    # ------------------------------------------------------------------ API
    def submit(self, features: dict) -> "_Pending":
        p = _Pending(next(self._ids), features, time.perf_counter(),
                     threading.Event())
        with self._lock:
            self._queue.append(p)
        return p

    def score(self, features: dict, timeout: float = 30.0) -> float:
        """Blocking convenience wrapper.  Re-raises ``score_fn`` failures."""
        p = self.submit(features)
        if not p.event.wait(timeout):
            raise TimeoutError("scoring request timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        self._stop = True
        self._worker.join(timeout=5)

    # ---------------------------------------------------------------- worker
    def _cut_batch(self) -> list[_Pending]:
        with self._lock:
            if not self._queue:
                return []
            oldest = self._queue[0].t_enqueue
            full = len(self._queue) >= self.max_batch
            stale = (time.perf_counter() - oldest) >= self.max_delay
            if not (full or stale):
                return []
            n = min(len(self._queue), self.max_batch)
            return [self._queue.popleft() for _ in range(n)]

    def _loop(self):
        while not self._stop:
            batch = self._cut_batch()
            if not batch:
                time.sleep(self.max_delay / 4)
                continue
            self._run(batch)

    def _run(self, batch: list[_Pending]):
        n = len(batch)
        try:
            b = bucket_for(n, self.buckets)
            keys = batch[0].features.keys()
            arrays = {}
            for k in keys:
                rows = np.stack([np.asarray(p.features[k]) for p in batch])
                pad = [(0, b - n)] + [(0, 0)] * (rows.ndim - 1)
                arrays[k] = np.pad(rows, pad)
            scores = np.asarray(self.score_fn(arrays))[:n]
            if scores.shape[0] < n:  # short result strands the tail pendings
                raise ValueError(
                    f"score_fn returned {scores.shape[0]} scores for {n} requests")
        except BaseException as e:  # noqa: BLE001 — a worker-thread failure
            # must never strand callers: park the exception on every pending
            # record and wake them (score() re-raises; raw submit() users see
            # .error set).
            for p in batch:
                p.error = e
                p.event.set()
            return
        self.n_batches += 1
        self.n_requests += n
        self.batch_sizes.append(n)
        t_done = time.perf_counter()
        for p, s in zip(batch, scores):
            p.result = float(s)
            p.t_done = t_done
            p.event.set()


def model_score_fn(model: torch.nn.Module, buffers: dict | None = None
                   ) -> Callable[[dict], np.ndarray]:
    """Score function for a port model: the padded numpy batch, every key
    of it (``sparse`` and ``dense``; DIN's ``hist``, ``hist_mask`` and
    ``target``), goes to the model's device, one forward without autograd,
    logits back as numpy."""
    device = next(model.parameters()).device

    def score(batch: dict) -> np.ndarray:
        with torch.inference_mode():
            tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for k, v in batch.items()}
            return model(tensors, buffers).cpu().numpy()

    return score
