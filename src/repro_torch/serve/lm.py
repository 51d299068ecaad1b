"""LM serving: prefill + greedy decode over a fixed-slot batch (port of
``repro.serve.lm``).

Sequences run in waves of up to ``n_slots``: each wave's prompts are
left-padded with token 0 (no mask: positions are absolute, so a shorter
prompt wastes a few cache rows) to a common length, prefilled, then decoded
greedily until every member has met ``eos_id`` or the wave's capacity.

One difference from the reference, in memory only: a wave's cache is made
at its decode capacity ``pad_to`` and the prefill writes its first ``plen``
rows in place, where the reference prefills a cache of ``plen`` rows and
pads it to ``pad_to`` (a copy of the whole cache, which at decode_32k would
not fit beside it).  The rows past ``plen`` are zeros either way.

Under an installed ``Mesh`` every rank runs the same server on the same
prompts: a wave's cache is this rank's slab of the ``pad_to``-row cache
(``transformer.init_cache``), and prefill and decode take the meshed
paths (``length`` = ``pad_to``); logits, and so tokens, are the whole
wave's on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer


@dataclasses.dataclass
class GenerationResult:
    prompt: list[int]
    tokens: list[int]
    finished: bool


class LMServer:
    """Batched greedy decoding, a wave of ``n_slots`` at a time, on the
    model's device."""

    def __init__(self, model: transformer.Transformer,
                 cfg: transformer.TransformerConfig, n_slots: int = 8,
                 max_len: int = 256, eos_id: Optional[int] = None):
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = next(model.parameters()).device
        self.stats = {"waves": 0, "decode_steps": 0, "generated": 0}

    def generate(self, prompts: list[list[int]],
                 max_new_tokens: int = 32) -> list[GenerationResult]:
        results: list[GenerationResult] = []
        for lo in range(0, len(prompts), self.n_slots):
            wave = prompts[lo: lo + self.n_slots]
            results.extend(self._run_wave(wave, max_new_tokens))
        return results

    def _run_wave(self, wave: list[list[int]],
                  max_new: int) -> list[GenerationResult]:
        self.stats["waves"] += 1
        n = len(wave)
        plen = max(len(p) for p in wave)
        toks = np.zeros((n, plen), np.int32)
        for i, p in enumerate(wave):
            toks[i, plen - len(p):] = p
        pad_to = min(self.max_len, plen + max_new)
        cache = transformer.init_cache(self.cfg, n, pad_to, self.device)
        logits, cache = transformer.prefill(
            self.model, self.cfg, torch.from_numpy(toks).to(self.device),
            cache=cache, length=pad_to)
        out_tokens = [[] for _ in range(n)]
        done = np.zeros(n, bool)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        cur_np = cur.cpu().numpy()
        for i in range(n):
            out_tokens[i].append(int(cur_np[i]))
        for step in range(1, max_new):
            if done.all() or plen + step >= pad_to:
                break
            logits, cache = transformer.decode_step(
                self.model, self.cfg, cur, cache, plen + step - 1,
                length=pad_to)
            self.stats["decode_steps"] += 1
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            cur_np = cur.cpu().numpy()
            for i in range(n):
                if not done[i]:
                    out_tokens[i].append(int(cur_np[i]))
                    if self.eos_id is not None and cur_np[i] == self.eos_id:
                        done[i] = True
        self.stats["generated"] += sum(len(t) for t in out_tokens)
        return [GenerationResult(list(p), t, bool(d))
                for p, t, d in zip(wave, out_tokens, done)]
