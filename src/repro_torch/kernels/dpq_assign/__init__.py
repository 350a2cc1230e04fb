from repro_torch.kernels.dpq_assign.ops import (assign, dpq_assign,
                                                dpq_assign_blocked_ref,
                                                dpq_assign_ref)

__all__ = ["assign", "dpq_assign", "dpq_assign_blocked_ref",
           "dpq_assign_ref"]
