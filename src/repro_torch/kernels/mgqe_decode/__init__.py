from repro_torch.kernels.mgqe_decode.ops import (decode, mgqe_decode,
                                                 mgqe_decode_ref)

__all__ = ["decode", "mgqe_decode", "mgqe_decode_ref"]
