from repro_torch.kernels.mgqe_decode.ops import (decode, decode_stages,
                                                 mgqe_decode, mgqe_decode_ref,
                                                 rq_decode_stages,
                                                 rq_decode_stages_ref)

__all__ = ["decode", "decode_stages", "mgqe_decode", "mgqe_decode_ref",
           "rq_decode_stages", "rq_decode_stages_ref"]
