"""qwen3-moe-30b-a3b  [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 — pure full attention
(long_500k cell skipped, DESIGN.md §4).  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_common import lm_embedding

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    act="silu",
    param_dtype="bfloat16",
    embedding=lm_embedding(151936, 2048),
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=32,
        vocab_size=512, num_experts=8, num_experts_per_tok=2,
        act="silu", dtype="float32", remat=False, xent_chunk=8,
        embedding=lm_embedding(512, 64, num_subspaces=4),
    )
