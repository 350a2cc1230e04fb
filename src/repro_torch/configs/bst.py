"""bst  [recsys] embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq (Behavior Sequence
Transformer, Alibaba).  [arXiv:1905.06874; paper]
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="bst",
    model="bst",
    n_sparse=0,
    field_vocab_sizes=(),
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    bst_heads=8,
    tower_mlp=(1024, 512, 256),
    n_items=10_000_000,
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="bst-smoke", model="bst", n_sparse=0, field_vocab_sizes=(),
        embed_dim=32, seq_len=10, n_blocks=1, bst_heads=4,
        tower_mlp=(64, 32), n_items=30_000)
