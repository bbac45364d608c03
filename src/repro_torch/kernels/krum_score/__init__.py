"""Krum scores from Gram matrices (CUDA kernel + plain)."""
from repro_torch.kernels.krum_score.krum_score import (krum_score,
                                                       krum_score_plain,
                                                       krum_scores)

__all__ = ["krum_score", "krum_score_plain", "krum_scores"]
