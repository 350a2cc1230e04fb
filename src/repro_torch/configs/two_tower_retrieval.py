"""two-tower-retrieval  [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot, sampled-softmax retrieval.  [RecSys'19 (YouTube)]
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="two-tower-retrieval",
    model="two_tower",
    n_sparse=0,
    field_vocab_sizes=(),
    embed_dim=256,
    tower_mlp=(1024, 512, 256),
    n_items=10_000_000,
    n_users=50_000_000,
    num_subspaces=16,
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="two-tower-smoke", model="two_tower", n_sparse=0,
        field_vocab_sizes=(), embed_dim=32, tower_mlp=(64, 32),
        n_items=30_000, n_users=50_000, num_subspaces=8)
