"""Gram matrix and pairwise squared distances (CUDA kernel + plain)."""
from repro_torch.kernels.pairwise_dist.pairwise_dist import (
    GRAM_CHUNK, gram, gram_chunks, gram_plain, pairwise_sq_dists,
    sq_dists_from_gram)

__all__ = ["GRAM_CHUNK", "gram", "gram_chunks", "gram_plain",
           "pairwise_sq_dists", "sq_dists_from_gram"]
