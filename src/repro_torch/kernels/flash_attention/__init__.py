"""Flash attention: the CUDA kernel, its plain version and the
model-layout wrapper."""
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention", "flash_attention_kernel",
           "flash_attention_plain"]
