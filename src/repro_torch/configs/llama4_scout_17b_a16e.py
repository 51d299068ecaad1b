"""llama4-scout-17b-a16e [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192.

MoE 16 experts top-1 + shared expert, every layer  [hf:meta-llama/
Llama-4-Scout-17B-16E; unverified] (copy of
``repro.configs.llama4_scout_17b_a16e``).  The assigned shapes are token
shapes: the vision frontend is out of scope.  At 108B parameters it fits no
single card whole: one H100 runs it at full width and reduced depth
(``dataclasses.replace(cfg, n_layers=4)``).
"""
from repro_torch.configs._lm_common import LM_SHAPES
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.nn.moe import MoEConfig


def make_model(shape_id=None):
    return TransformerConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab_size=202048, norm="rmsnorm",
        rope_theta=500_000.0,
        moe=MoEConfig(d_model=5120, d_ff=8192, n_experts=16, top_k=1,
                      n_shared_experts=1, router="softmax",
                      capacity_factor=1.25),
        first_k_dense=0, tied_embeddings=False, dtype="bfloat16",
        remat=True, attn_block=1024, loss_chunk=256, kv_cache_dtype="int8")


def make_smoke():
    return TransformerConfig(
        name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=96, vocab_size=512, norm="rmsnorm",
        moe=MoEConfig(d_model=64, d_ff=96, n_experts=4, top_k=1,
                      n_shared_experts=1, router="softmax"),
        tied_embeddings=False, dtype="float32", remat=False, attn_block=16)


register(ArchConfig(
    arch_id="llama4-scout-17b-a16e", family="lm", make_model=make_model,
    make_smoke=make_smoke, shapes=LM_SHAPES, optimizer="adam",
    learning_rate=3e-4, source="hf:meta-llama/Llama-4-Scout-17B-16E"))
