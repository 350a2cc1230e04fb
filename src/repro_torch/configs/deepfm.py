"""deepfm  [recsys] n_sparse=39 embed_dim=10 mlp=400-400-400
interaction=fm.  [arXiv:1703.04247; paper]
"""
from repro_torch.configs.base import RecsysConfig
from repro_torch.data.synthetic import criteo_field_vocabs

CONFIG = RecsysConfig(
    name="deepfm",
    model="deepfm",
    n_sparse=39,
    embed_dim=10,
    field_vocab_sizes=criteo_field_vocabs(39),
    mlp_dims=(400, 400, 400),
    num_subspaces=5,   # embed_dim=10 must divide D
)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="deepfm-smoke", model="deepfm", n_sparse=6, embed_dim=10,
        field_vocab_sizes=(50_000, 20_000, 500, 500, 100, 100),
        mlp_dims=(32, 32), num_subspaces=5)
