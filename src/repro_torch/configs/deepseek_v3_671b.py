"""deepseek-v3-671b [moe] 61L d_model=7168 128H d_ff=2048(expert) vocab=129280.

MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128), 1 shared + 256 routed
top-8 sigmoid router, first 3 layers dense (d_ff 18432)  [arXiv:2412.19437; hf]
(copy of ``repro.configs.deepseek_v3_671b``).

The backbone and primary head; MTP (multi-token prediction) is not part of
it.  At 671B parameters it fits no single card whole: one H100 runs it at
full width and reduced depth (``dataclasses.replace(cfg, n_layers=4)``: the
3 dense layers and 1 MoE layer).
"""
from repro_torch.configs._lm_common import LM_SHAPES
from repro_torch.configs.base import ArchConfig, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.nn.attention import MLAConfig
from repro_torch.nn.moe import MoEConfig


def make_model(shape_id=None):
    return TransformerConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, d_ff=18432, vocab_size=129280, norm="rmsnorm",
        attention="mla",
        mla=MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                      kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                      n_shared_experts=1, router="sigmoid",
                      capacity_factor=1.25),
        first_k_dense=3, tied_embeddings=False, dtype="bfloat16",
        remat=True, attn_block=1024, loss_chunk=256, kv_cache_dtype="int8")


def make_smoke():
    return TransformerConfig(
        name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512, norm="rmsnorm", attention="mla",
        mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2,
                      n_shared_experts=1, router="sigmoid"),
        first_k_dense=1, tied_embeddings=False, dtype="float32", remat=False,
        attn_block=16)


register(ArchConfig(
    arch_id="deepseek-v3-671b", family="lm", make_model=make_model,
    make_smoke=make_smoke, shapes=LM_SHAPES, optimizer="adafactor",
    learning_rate=1e-2, source="arXiv:2412.19437",
    notes="MLA + sigmoid top-8 MoE; adafactor factored 2nd moment for HBM fit"))
