"""Compatibility shim — ADC lives in the retrieval package.

The single-query ADC helpers grew into ``repro_torch.retrieval``: an
index registry with ``flat_pq`` (the exact scan these helpers
implement) and ``ivf_pq``, and the batched top-k kernels.  This module
re-exports the original surface so existing imports keep working; new
code should use ``repro_torch.retrieval`` directly.
"""
from repro_torch.retrieval.flat_pq import (adc_scores, build_corpus_artifact,
                                           encode_corpus, fit_pq,
                                           reconstruction_mse)

__all__ = ["adc_scores", "build_corpus_artifact", "encode_corpus",
           "fit_pq", "reconstruction_mse"]
