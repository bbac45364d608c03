"""Gram matrix and pairwise squared distances (CUDA kernel + plain)."""
from repro_torch.kernels.pairwise_dist.pairwise_dist import (
    gram, gram_plain, pairwise_sq_dists)

__all__ = ["gram", "gram_plain", "pairwise_sq_dists"]
