"""stablelm-3b [dense] 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b; unverified] - LayerNorm + SwiGLU, untied
(copy of ``repro.configs.stablelm_3b``).
"""
from repro_torch.configs._lm_common import LM_SHAPES
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.transformer import TransformerConfig


def make_model(shape_id=None):
    return TransformerConfig(
        name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32,
        n_kv_heads=32, d_ff=6912, vocab_size=50304, norm="layernorm",
        qkv_bias=False, rope_theta=10000.0, tied_embeddings=False,
        dtype="bfloat16", remat=True, attn_block=1024, loss_chunk=512,
        kv_cache_dtype="int8")


def make_smoke():
    return TransformerConfig(
        name="stablelm-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab_size=512, norm="layernorm",
        tied_embeddings=False, dtype="float32", remat=False, attn_block=16)


register(ArchConfig(
    arch_id="stablelm-3b", family="lm", make_model=make_model,
    make_smoke=make_smoke, shapes=LM_SHAPES, optimizer="adam",
    learning_rate=3e-4, source="hf:stabilityai/stablelm-2-1_6b"))
