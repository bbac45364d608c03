"""The CUDA kernels against their plain versions, on a GPU.

    python -m pytest -m cuda tests/test_torch_cuda.py

Every test here needs a CUDA device and skips without one. The module
imports no JAX, so it runs on a machine that has only PyTorch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.pairwise_dist import gram, gram_plain  # noqa: E402
from repro_torch.kernels.rfa import (  # noqa: E402
    weighted_sum, weighted_sum_plain, weiszfeld_plain, weiszfeld_weights)


def _stack(shape, seed=0, offset=1.5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) + offset


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 13, 386), (13, 7, 4868),
                                   (1, 32, 1000), (2, 1, 5)])
def test_cuda_kernels_match_plain(cuda, shape):
    x = torch.from_numpy(_stack(shape, 8)).to(cuda)
    before = dispatch.launch_counts()
    g = gram(x)
    assert torch.equal(g, gram(x))                  # fixed-order sums
    assert torch.equal(g, g.transpose(1, 2))        # same products
    scale = g.abs().max().item()
    torch.testing.assert_close(g, gram_plain(x), rtol=0, atol=2e-5 * scale)
    w = weiszfeld_weights(g, 1e-6, 32)
    torch.testing.assert_close(w, weiszfeld_plain(g, 1e-6, 32), rtol=0,
                               atol=1e-5)
    z = weighted_sum(x, w)
    torch.testing.assert_close(z, weighted_sum_plain(x, w), rtol=0,
                               atol=1e-5 * x.abs().max().item())
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "gram": 2, "weiszfeld": 1, "wsum": 1}


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="K <= 32"):
        gram(torch.zeros((1, 33, 8), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        gram(torch.zeros((1, 3, 8), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        gram(torch.zeros((1, 8, 3), device=cuda).transpose(1, 2))
    x = torch.zeros((2, 3, 8), device=cuda)
    with pytest.raises(ValueError, match="weights"):
        weighted_sum(x, torch.zeros((2, 4), device=cuda))
