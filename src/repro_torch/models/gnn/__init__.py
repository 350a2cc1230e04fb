"""Equivariant GNN family: MACE (higher-order E(3)-ACE message passing),
trained on the card.  Message passing is a gather over the edge index
and a receiver-indexed scatter-sum (``mace.py::segment_sum``), both
with sorted, repeatable backwards."""
from repro_torch.models.gnn.mace import MACE, bessel_basis

__all__ = ["MACE", "bessel_basis"]
