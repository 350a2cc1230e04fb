"""Hand-written CUDA kernels for Hopper, one per op of the ported path.

Each subpackage ships <name>.py (the ctypes wrappers of the kernels in
``csrc/``), ops.py (dispatch-registered public op) and ref.py
(the plain PyTorch version):

  mgqe_decode     codes + centroids -> embeddings (serving hot path),
                  and rq_decode_stages, the residual-stage sum (rq)
  packed_decode   bit-packed codes -> embeddings (mpe), unpacked in
                  registers
  dpq_assign      nearest-centroid search (export and index build)
  pq_score        ADC scoring of a PQ-coded corpus: pq_score,
                  pq_score_batched, pq_topk (retrieval hot path)
  embedding_bag   ragged gather + weighted segment sum (the recsys
                  fields' pooled multi-hot lookup)
  flash_attention causal/windowed GQA attention with an online softmax
                  (the LM's chunked prefill route)

Backend selection (cuda | torch) is centralized in ``dispatch.py``;
``build.py`` compiles the sources with nvcc at first use.  Nothing here
builds or loads a kernel at import time.
"""
from repro_torch.kernels import dispatch  # noqa: F401  (must import first)
from repro_torch.kernels import (dpq_assign, embedding_bag, flash_attention,
                                 mgqe_decode, packed_decode, pq_score)

__all__ = ["dispatch", "dpq_assign", "embedding_bag", "flash_attention",
           "mgqe_decode", "packed_decode", "pq_score"]
