"""Quantized retrieval: batched top-k candidate retrieval over
PQ-coded corpora.

An :class:`~repro_torch.retrieval.base.Index` protocol with a plugin
registry (mirroring ``core/schemes/``) and, in this slice, one kind —

  ``flat_pq``  exact batched ADC scan (the ``pq_topk`` kernel)

plus deterministic top-k merging (``topk.py``) and the index build's
flat half (``build.py``).  Serve through
:class:`repro_torch.launch.engine.RetrievalEngine`.  ``ivf_pq``,
host-staged serving and sharded search are later slices in ROADMAP.md;
asking for ``ivf_pq`` raises the registry's unknown-kind error.
"""
from repro_torch.retrieval import flat_pq  # noqa: F401  (registers the kind)
from repro_torch.retrieval.base import (Index, IndexConfig, get_index,
                                        index_class, register_index,
                                        registered_index_kinds,
                                        suggest_nlist)
from repro_torch.retrieval.build import BuildStats, build_flat_artifact
from repro_torch.retrieval.flat_pq import FlatPQ
from repro_torch.retrieval.topk import INVALID_ID, merge_topk, topk_by_position

__all__ = ["BuildStats", "FlatPQ", "INVALID_ID", "Index", "IndexConfig",
           "build_flat_artifact", "get_index", "index_class", "merge_topk",
           "register_index", "registered_index_kinds", "suggest_nlist",
           "topk_by_position"]
