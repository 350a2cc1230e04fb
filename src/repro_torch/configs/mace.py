"""mace  [gnn] n_layers=2 d_hidden=128 l_max=2 correlation_order=3
n_rbf=8 equivariance=E(3)-ACE.  [arXiv:2206.07697; paper]

MGQE inapplicable (species vocab ~100 — DESIGN.md §4).
"""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="mace",
    num_layers=2,
    d_hidden=128,
    l_max=2,
    correlation_order=3,
    n_rbf=8,
    num_species=100,
    d_readout=16,
)


def smoke_config() -> GNNConfig:
    return GNNConfig(name="mace-smoke", num_layers=2, d_hidden=16, l_max=2,
                     correlation_order=3, n_rbf=4, num_species=10,
                     d_readout=4)
