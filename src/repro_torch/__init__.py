"""PyTorch + CUDA port of the MGQE/DPQ embedding system for NVIDIA Hopper.

A second package beside the JAX reference ``repro``; it mirrors
``repro``'s module paths and imports nothing of it (nor JAX).  Ported
so far: the export-and-serve path for ``full``/``dpq``/``mgqe`` tables,
with hand-written CUDA kernels for the two ops on it
(``kernels/csrc/``).  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
