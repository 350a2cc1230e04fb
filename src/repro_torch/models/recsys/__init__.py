"""Recsys models: DeepFM, AutoInt and BST (served and trained), two-tower
retrieval (served and trained), the field-embedding collection they
share, and the paper's three backbones (``backbones.py``: GMF, NeuMF
and SASRec, trained, exported and served; run by
``launch/backbones.py``)."""
from repro_torch.models.recsys.autoint import AutoInt
from repro_torch.models.recsys.bst import BST

__all__ = ["AutoInt", "BST"]
