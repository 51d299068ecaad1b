"""tinyllama-1.1b [dense] 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

llama2-arch small [arXiv:2401.02385; hf] (copy of
``repro.configs.tinyllama_1_1b``).
"""
from repro_torch.configs._lm_common import LM_SHAPES
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.transformer import TransformerConfig


def make_model(shape_id=None):
    return TransformerConfig(
        name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=5632, vocab_size=32000, norm="rmsnorm",
        qkv_bias=False, rope_theta=10000.0, tied_embeddings=False,
        dtype="bfloat16", remat=True, attn_block=1024, loss_chunk=512,
        kv_cache_dtype="int8")


def make_smoke():
    return TransformerConfig(
        name="tinyllama-1.1b-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=160, vocab_size=512, norm="rmsnorm",
        tied_embeddings=False, dtype="float32", remat=False, attn_block=16)


register(ArchConfig(
    arch_id="tinyllama-1.1b", family="lm", make_model=make_model,
    make_smoke=make_smoke, shapes=LM_SHAPES, optimizer="adam",
    learning_rate=4e-4, source="arXiv:2401.02385"))
