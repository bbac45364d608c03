"""Gram-space RFA: Weiszfeld weights and the weighted sum (CUDA kernels
+ plain)."""
from repro_torch.kernels.rfa.rfa import (rfa, weighted_sum,
                                         weighted_sum_plain,
                                         weiszfeld_instance,
                                         weiszfeld_plain, weiszfeld_weights)

__all__ = ["rfa", "weighted_sum", "weighted_sum_plain", "weiszfeld_instance",
           "weiszfeld_plain", "weiszfeld_weights"]
