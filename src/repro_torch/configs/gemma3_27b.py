"""gemma3-27b  [dense] 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_common import lm_embedding

CONFIG = LMConfig(
    name="gemma3-27b",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    sliding_window=1024,
    local_global_pattern=5,       # 5 local : 1 global
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    act="gelu",
    param_dtype="bfloat16",
    embedding=lm_embedding(262144, 5376),
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="gemma3-27b-smoke",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, sliding_window=8, local_global_pattern=5,
        act="gelu", dtype="float32", remat=False, xent_chunk=8,
        embedding=lm_embedding(512, 64, num_subspaces=4),
    )
