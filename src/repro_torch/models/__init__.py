"""Model families; the recsys family (DeepFM, two-tower) is ported, the
LM and GNN families follow their slices in ROADMAP.md."""
