"""Shared pieces for the LM architecture configs (copy of
``repro.configs._lm_common``)."""
from __future__ import annotations

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

# (seq_len, global_batch, step kind)
LM_SHAPE_TABLE = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    # one new token against a 524288-token KV cache: O(L) per step, valid for
    # full-attention archs
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
