"""The CUDA kernels against their plain versions, on a GPU.

    python -m pytest -m cuda tests/test_torch_cuda.py

Every test here needs a CUDA device and skips without one. The module
imports no JAX, so it runs on a machine that has only PyTorch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.gossip_reduce import (  # noqa: E402
    gossip_reduce, gossip_reduce_plain, neighbor_reduce,
    neighbor_reduce_plain)
from repro_torch.kernels.krum_score import (  # noqa: E402
    krum_score, krum_score_plain)
from repro_torch.kernels.pairwise_dist import gram, gram_plain  # noqa: E402
from repro_torch.kernels.rfa import (  # noqa: E402
    weighted_sum, weighted_sum_plain, weiszfeld_plain, weiszfeld_weights)
from repro_torch.kernels.trimmed_mean import (  # noqa: E402
    trimmed_mean, trimmed_mean_plain)
from repro_torch.topology import resolve_topology  # noqa: E402

CW = ("krum_score", "trimmed_mean", "gossip_reduce", "neighbor_reduce")


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
    assert {k: after[k] - before[k] for k in ("gram", "weiszfeld", "wsum")} \
        == {"gram": 2, "weiszfeld": 1, "wsum": 1}


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


def _grid(shape, seed):
    """Small integers: every sum is exact, so kernel and plain version
    must agree bit for bit."""
    return np.random.default_rng(seed).integers(-4, 5, shape).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("K,d,topology", [(13, 386, "complete"),
                                          (13, 386, "ring(k=4)"),
                                          (9, 1000, "complete"),
                                          (32, 300, "complete")])
@pytest.mark.parametrize("grid", [False, True], ids=["normal", "grid"])
def test_cuda_cw_kernels_match_plain(cuda, K, d, topology, grid):
    make = _grid if grid else _stack
    x = torch.from_numpy(make((2, K, d), 9)).to(cuda)
    x[1, 3] = x[1, 5]                               # tied rows
    nbr = torch.as_tensor(resolve_topology(topology, K).nbr_idx,
                          dtype=torch.int64, device=cuda)
    P = nbr.shape[1]
    recv = torch.from_numpy(make((K, P, d), 10)).to(cuda)
    before = dispatch.launch_counts()

    def same(fn, plain, *args, tol):
        out = fn(*args)
        assert torch.equal(out, fn(*args))          # fixed-order sums
        torch.testing.assert_close(out, plain(*args), rtol=0,
                                   atol=0 if grid else tol)

    # the plain versions sum in the kernels' order: the tolerance is what
    # another order could cost, P·eps·max|x|
    eps = torch.finfo(torch.float32).eps
    g = gram(x)
    scale = krum_score_plain(g, K - 5).abs().max().item()
    same(krum_score, krum_score_plain, g, K - 5, tol=K * eps * scale)
    n_trim = (K - 1) // 4
    same(trimmed_mean, trimmed_mean_plain, x, n_trim,
         tol=K * eps * x.abs().max().item())
    for mode, nt in (("mean", 0), ("median", 0), ("trimmed", (P - 1) // 2)):
        same(gossip_reduce, gossip_reduce_plain, x[0].contiguous(), nbr,
             mode, nt, tol=P * eps * x.abs().max().item())
        same(neighbor_reduce, neighbor_reduce_plain, recv, mode, nt,
             tol=P * eps * recv.abs().max().item())
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    assert {k: after[k] - before[k] for k in CW + ("gram",)} == {
        "gram": 1, "krum_score": 2, "trimmed_mean": 2, "gossip_reduce": 6,
        "neighbor_reduce": 6}


@pytest.mark.cuda
def test_cuda_cw_wrappers_reject_what_the_kernels_do_not_take(cuda):
    nbr = torch.zeros((4, 3), dtype=torch.int64, device=cuda)
    msgs = torch.zeros((4, 8), device=cuda)
    # check_mode's errors come first
    with pytest.raises(ValueError, match="unknown gossip reduce mode"):
        gossip_reduce(msgs, nbr, "sum", 0)
    with pytest.raises(ValueError, match="deg_max > 2\\*n_trim"):
        neighbor_reduce(torch.zeros((4, 3, 8), device=cuda), "trimmed", 2)
    with pytest.raises(ValueError, match="P <= 32"):
        neighbor_reduce(torch.zeros((4, 33, 8), device=cuda), "mean", 0)
    with pytest.raises(ValueError, match="P <= 32"):
        gossip_reduce(msgs, torch.zeros((4, 33), dtype=torch.int64,
                                        device=cuda), "median", 0)
    with pytest.raises(TypeError, match="float32"):
        gossip_reduce(msgs.double(), nbr, "mean", 0)
    with pytest.raises(ValueError, match="contiguous"):
        neighbor_reduce(torch.zeros((4, 8, 3), device=cuda).transpose(1, 2),
                        "mean", 0)
    with pytest.raises(ValueError, match="nbr"):
        gossip_reduce(msgs, nbr.int(), "mean", 0)
    with pytest.raises(ValueError, match="nbr"):
        gossip_reduce(msgs, nbr[:3].contiguous(), "mean", 0)
    with pytest.raises(ValueError, match="nbr"):
        gossip_reduce(msgs, nbr.cpu(), "mean", 0)
    # an index outside [0, K) is not followed: that receiver's row is NaN
    bad = nbr.clone()
    bad[2, 1] = 4
    out = gossip_reduce(msgs + 1.0, bad, "mean", 0)
    assert torch.isnan(out[2]).all() and (out[[0, 1, 3]] == 1.0).all()
    with pytest.raises(ValueError, match="K <= 32"):
        trimmed_mean(torch.zeros((1, 33, 8), device=cuda), 1)
    with pytest.raises(ValueError, match="K > 2\\*n_trim"):
        trimmed_mean(torch.zeros((1, 6, 8), device=cuda), 3)
    with pytest.raises(TypeError, match="float32"):
        trimmed_mean(torch.zeros((1, 6, 8), device=cuda,
                                 dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="K <= 32"):
        krum_score(torch.zeros((1, 33, 33), device=cuda), 4)
    with pytest.raises(ValueError, match="Gram"):
        krum_score(torch.zeros((1, 4, 5), device=cuda), 2)
    with pytest.raises(TypeError, match="float32"):
        krum_score(torch.zeros((1, 4, 4), device=cuda,
                               dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="contiguous"):
        krum_score(torch.zeros((4, 4, 1), device=cuda).transpose(0, 2), 2)


def _qkv(B, H, Hkv, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((B * H, Sq, hd), (B * Hkv, Sk, hd),
                          (B * Hkv, Sk, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (1, 32, 8, 512, 64),            # Llama-3.2-1B's prefill, G = 4
    (1, 16, 2, 256, 128),           # Qwen2.5-3B's, G = 8
    (2, 2, 2, 9, 32),               # the policy's, ragged
    (1, 4, 1, 100, 64),             # ragged, G = 4
    (2, 4, 2, 130, 32),             # G = 2
])
@pytest.mark.parametrize("window", [None, 1, 7, 128])
def test_cuda_flash_attention_matches_plain(cuda, B, H, Hkv, S, hd, window):
    q, k, v = (t.to(cuda) for t in _qkv(B, H, Hkv, S, S, hd, 11))
    before = dispatch.launch_counts()["flash_attention"]
    out = flash_attention_kernel(q, k, v, H, window)
    assert torch.equal(out, flash_attention_kernel(q, k, v, H, window))
    # f32 sums in another order than the plain version's matmuls: the
    # tolerance of the reference's own kernel tests, relative to max|v|
    torch.testing.assert_close(
        out, flash_attention_plain(q, k, v, H, window), rtol=0,
        atol=2e-5 * v.abs().max().item())
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,window", [(100, 70, None), (70, 100, 30)])
def test_cuda_flash_attention_unequal_lengths(cuda, Sq, Sk, window):
    q, k, v = (t.to(cuda) for t in _qkv(2, 4, 2, Sq, Sk, 64, 13))
    out = flash_attention_kernel(q, k, v, 4, window)
    torch.testing.assert_close(
        out, flash_attention_plain(q, k, v, 4, window), rtol=0,
        atol=2e-5 * v.abs().max().item())


@pytest.mark.cuda
def test_cuda_flash_attention_model_layout_and_rejects(cuda):
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(cuda)
               for s in ((2, 40, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    out = flash_attention(q, k, v)
    want = flash_attention(q.cpu(), k.cpu(), v.cpu())
    torch.testing.assert_close(out.cpu(), want, rtol=0,
                               atol=2e-5 * v.abs().max().item())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(torch.zeros((2, 8, 48), device=cuda),
                               torch.zeros((2, 8, 48), device=cuda),
                               torch.zeros((2, 8, 48), device=cuda), 2)
    with pytest.raises(TypeError, match="float32"):
        flash_attention_kernel(torch.zeros((2, 8, 64), device=cuda,
                                           dtype=torch.float64),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(torch.zeros((2, 64, 8), device=cuda
                                           ).transpose(1, 2),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2)
    with pytest.raises(ValueError, match="window"):
        flash_attention_kernel(torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2, 0)
