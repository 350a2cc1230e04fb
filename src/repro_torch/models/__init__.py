"""Model families: the recsys family (DeepFM, AutoInt, BST, two-tower and
the paper's backbones), the LMs (``lm.py``, dense and MoE) and the GNN
family (``gnn/``: MACE)."""
