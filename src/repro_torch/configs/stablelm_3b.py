"""stablelm-3b  [dense] 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 — pure full attention.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_common import lm_embedding

CONFIG = LMConfig(
    name="stablelm-3b",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    act="silu",
    embedding=lm_embedding(50304, 2560),
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="stablelm-3b-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
        vocab_size=512, act="silu", dtype="float32", remat=False,
        xent_chunk=8, embedding=lm_embedding(512, 64, num_subspaces=4),
    )
