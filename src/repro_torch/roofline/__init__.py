"""The roofline model on H100 constants (``model.py``); the JAX
package's ``roofline/hlo.py`` parses XLA HLO and has no twin here: the
port's counts come from tracing a step on the meta device."""
from repro_torch.roofline.model import (GPUS_PER_NODE, HBM_BW, IB_BW,
                                        NVLINK_BW, PEAK_FLOPS, CostCounter,
                                        RooflineTerms, axis_link_bw,
                                        gnn_step_flops, kernel_roofline,
                                        lm_forward_model_flops,
                                        lm_prefill_flops, lm_train_flops,
                                        lm_train_model_flops, op_roofline,
                                        peak_flops, terms)

__all__ = ["CostCounter", "GPUS_PER_NODE", "HBM_BW", "IB_BW", "NVLINK_BW",
           "PEAK_FLOPS", "RooflineTerms", "axis_link_bw", "gnn_step_flops",
           "kernel_roofline", "lm_forward_model_flops", "lm_prefill_flops",
           "lm_train_flops", "lm_train_model_flops", "op_roofline",
           "peak_flops", "terms"]
