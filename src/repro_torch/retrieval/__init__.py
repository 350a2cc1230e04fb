"""Quantized retrieval: batched top-k candidate retrieval over
PQ-coded corpora.

An :class:`~repro_torch.retrieval.base.Index` protocol with a plugin
registry (mirroring ``core/schemes/``) and two kinds —

  ``flat_pq``  exact batched ADC scan (the ``pq_topk`` kernel)
  ``ivf_pq``   coarse k-means partition + per-list PQ codes,
               ``nprobe``-controlled probing, servable with its list
               tables in host memory (``search_host_staged``)

plus deterministic top-k merging (``topk.py``) and the index builds
(``build.py``: sampled fit, blocked encode, the IVF list layout from a
host corpus).  Serve through
:class:`repro_torch.launch.engine.RetrievalEngine`.  Sharded search is
a later slice in ROADMAP.md.
"""
from repro_torch.retrieval import flat_pq, ivf_pq  # noqa: F401  (register kinds)
from repro_torch.retrieval.base import (Index, IndexConfig, get_index,
                                        index_class, register_index,
                                        registered_index_kinds,
                                        suggest_nlist)
from repro_torch.retrieval.build import (BuildStats, build_flat_artifact,
                                         build_ivf_artifact)
from repro_torch.retrieval.flat_pq import FlatPQ
from repro_torch.retrieval.ivf_pq import IVFPQ
from repro_torch.retrieval.topk import INVALID_ID, merge_topk, topk_by_position

__all__ = ["BuildStats", "FlatPQ", "IVFPQ", "INVALID_ID", "Index",
           "IndexConfig", "build_flat_artifact", "build_ivf_artifact",
           "get_index", "index_class", "merge_topk", "register_index",
           "registered_index_kinds", "suggest_nlist", "topk_by_position"]
