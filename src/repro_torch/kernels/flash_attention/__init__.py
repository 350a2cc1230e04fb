from repro_torch.kernels.flash_attention.ops import (attend, flash_attention,
                                                     flash_attention_ref)

__all__ = ["attend", "flash_attention", "flash_attention_ref"]
