"""mixtral-8x7b  [moe] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, SWA 4096 (bounded cache => long_500k
runs).  [arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_common import lm_embedding

CONFIG = LMConfig(
    name="mixtral-8x7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    act="silu",
    param_dtype="bfloat16",
    embedding=lm_embedding(32000, 4096),
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="mixtral-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
        vocab_size=512, sliding_window=8, num_experts=4,
        num_experts_per_tok=2, act="silu", dtype="float32", remat=False,
        xent_chunk=8, embedding=lm_embedding(512, 64, num_subspaces=4),
    )
