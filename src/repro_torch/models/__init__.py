"""Model families: the recsys family (DeepFM, two-tower) and the dense
LMs (``lm.py``) are ported; MoE LMs and the GNN family follow their
slices in ROADMAP.md."""
