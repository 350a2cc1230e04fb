"""autoint  [recsys] n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn.  [arXiv:1810.11921; paper]
"""
from repro_torch.configs.base import RecsysConfig
from repro_torch.data.synthetic import criteo_field_vocabs

CONFIG = RecsysConfig(
    name="autoint",
    model="autoint",
    n_sparse=39,
    embed_dim=16,
    field_vocab_sizes=criteo_field_vocabs(39),
    n_attn_layers=3,
    n_attn_heads=2,
    d_attn=32,
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="autoint-smoke", model="autoint", n_sparse=6, embed_dim=16,
        field_vocab_sizes=(50_000, 20_000, 500, 500, 100, 100),
        n_attn_layers=2, n_attn_heads=2, d_attn=16)
