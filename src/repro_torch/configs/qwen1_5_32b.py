"""qwen1.5-32b [dense] 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.

QKV bias [hf:Qwen/Qwen1.5-0.5B; hf] (copy of ``repro.configs.qwen1_5_32b``).
"""
from repro_torch.configs._lm_common import LM_SHAPES
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.transformer import TransformerConfig


def make_model(shape_id=None):
    return TransformerConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, d_ff=27392, vocab_size=152064, norm="rmsnorm",
        qkv_bias=True, rope_theta=1_000_000.0, tied_embeddings=False,
        dtype="bfloat16", remat=True, attn_block=1024, loss_chunk=512,
        kv_cache_dtype="int8")


def make_smoke():
    return TransformerConfig(
        name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=176, vocab_size=512, norm="rmsnorm",
        qkv_bias=True, tied_embeddings=False, dtype="float32", remat=False,
        attn_block=16)


register(ArchConfig(
    arch_id="qwen1.5-32b", family="lm", make_model=make_model,
    make_smoke=make_smoke, shapes=LM_SHAPES, optimizer="adam",
    learning_rate=3e-4, source="hf:Qwen/Qwen1.5-0.5B"))
