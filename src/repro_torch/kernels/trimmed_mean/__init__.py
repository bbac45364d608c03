"""Coordinate-wise trimmed mean over agents (CUDA kernel + plain)."""
from repro_torch.kernels.trimmed_mean.trimmed_mean import (
    trimmed_mean, trimmed_mean_plain)

__all__ = ["trimmed_mean", "trimmed_mean_plain"]
