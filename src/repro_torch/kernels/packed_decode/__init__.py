from repro_torch.kernels.packed_decode.ops import (PACK_BITS, decode,
                                                   pack_codes, packed_decode,
                                                   packed_decode_ref,
                                                   packed_width,
                                                   unpack_codes)

__all__ = ["PACK_BITS", "decode", "pack_codes", "packed_decode",
           "packed_decode_ref", "packed_width", "unpack_codes"]
