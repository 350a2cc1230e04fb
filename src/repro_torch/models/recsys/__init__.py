"""Recsys models: DeepFM (served and trained), two-tower retrieval
(served), the field-embedding collection they share, and the paper's
three backbones (``backbones.py``: GMF, NeuMF and SASRec, trained,
exported and served; run by ``launch/backbones.py``).  AutoInt and BST
follow their slices in ROADMAP.md."""
