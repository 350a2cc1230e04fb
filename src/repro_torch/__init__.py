"""PyTorch + CUDA port of the MGQE/DPQ embedding system for NVIDIA Hopper.

A second package beside the JAX reference ``repro``; it mirrors
``repro``'s module paths and imports nothing of it (nor JAX).  Ported
so far: every embedding scheme kind (``full``, ``dpq``, the ``mgqe``
variants, ``rq``, ``mpe`` and the ``lrf``/``sq``/``hash`` baselines),
exported, served and trained; the ``ServingEngine`` and
``RetrievalEngine``; ``flat_pq`` retrieval; DeepFM and two-tower
serving, DeepFM training with checkpoints; dense LM serving
(gemma3-4b, stablelm-3b).  Every Pallas kernel of the JAX package has a
hand-written CUDA counterpart in ``kernels/csrc/``.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
