from repro_torch.kernels.pq_score.ops import (INVALID_ID, build_lut,
                                              build_lut_batch,
                                              build_lut_batch_ref,
                                              build_lut_ref, pq_score,
                                              pq_score_batched,
                                              pq_score_batched_ref,
                                              pq_score_ref, pq_topk,
                                              pq_topk_ref, score_candidates,
                                              score_candidates_batched,
                                              topk_candidates)

__all__ = ["INVALID_ID", "build_lut", "build_lut_batch",
           "build_lut_batch_ref", "build_lut_ref", "pq_score",
           "pq_score_batched", "pq_score_batched_ref", "pq_score_ref",
           "pq_topk", "pq_topk_ref", "score_candidates",
           "score_candidates_batched", "topk_candidates"]
