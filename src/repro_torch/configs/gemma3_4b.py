"""gemma3-4b  [dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_common import lm_embedding

CONFIG = LMConfig(
    name="gemma3-4b",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    local_global_pattern=5,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    act="gelu",
    embedding=lm_embedding(262144, 2560),
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="gemma3-4b-smoke",
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, sliding_window=8, local_global_pattern=5,
        act="gelu", dtype="float32", remat=False, xent_chunk=8,
        embedding=lm_embedding(512, 64, num_subspaces=4),
    )
