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
from repro_torch.kernels.pairwise_dist import (  # noqa: E402
    GRAM_CHUNK, gram, gram_chunks, gram_plain)
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
    # the plain version is the kernel's order: the same bits
    assert torch.equal(w, weiszfeld_plain(g, 1e-6, 32))
    z = weighted_sum(x, w)
    torch.testing.assert_close(z, weighted_sum_plain(x, w), rtol=0,
                               atol=1e-5 * x.abs().max().item())
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    assert {k: after[k] - before[k] for k in ("gram", "weiszfeld", "wsum")} \
        == {"gram": 2, "weiszfeld": 1, "wsum": 1}


def _offset_copy(x):
    """The same values in a contiguous tensor whose base is 4 bytes past
    an allocation's start: never 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 4
    return y


def _check_gram_and_wsum(x):
    g = gram(x)
    assert torch.equal(g, gram(x))                  # bit-identical rerun
    assert torch.equal(g, g.transpose(1, 2))        # each pair once
    torch.testing.assert_close(g, gram_plain(x), rtol=0,
                               atol=2e-5 * g.abs().max().item())
    w = torch.softmax(torch.linspace(-1, 1, x.shape[1], device=x.device),
                      0).expand(x.shape[0], -1).contiguous()
    z = weighted_sum(x, w)
    assert torch.equal(z, weighted_sum(x, w))
    torch.testing.assert_close(z, weighted_sum_plain(x, w), rtol=0,
                               atol=1e-5 * x.abs().max().item())
    return g, z


# d around the chunk boundaries (bulk route where d % 4 == 0, direct
# route otherwise), the unaligned widths of the main path, K = 1 and 32,
# and batches of several chunks
GRAM_CASES = [(1, 13, GRAM_CHUNK - 1), (1, 13, GRAM_CHUNK),
              (1, 13, GRAM_CHUNK + 1), (1, 13, 2 * GRAM_CHUNK + 3),
              (1, 13, 2 * GRAM_CHUNK + 4), (13, 13, 386), (13, 7, 4867),
              (2, 1, GRAM_CHUNK + 8), (1, 1, 3), (2, 32, 2 * GRAM_CHUNK + 3),
              (1, 32, 2 * GRAM_CHUNK), (3, 17, 3 * GRAM_CHUNK + 4),
              (3, 16, 3 * GRAM_CHUNK + 1), (4, 5, 5 * GRAM_CHUNK),
              (2, 25, GRAM_CHUNK + 4), (1, 10, 4867),
              (1, 3, 1 << 20)]           # wsum's vector route (>= 2^20)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRAM_CASES, ids=str)
def test_cuda_gram_and_wsum_routes(cuda, shape):
    x = torch.from_numpy(_stack(shape, sum(shape))).to(cuda)
    before = dispatch.launch_counts()
    g, z = _check_gram_and_wsum(x)
    # the other load route on the same values gives the same bits
    g2, z2 = _check_gram_and_wsum(_offset_copy(x))
    assert torch.equal(g, g2) and torch.equal(z, z2)
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    # one count per wrapper call, however many chunks the plan has
    assert {k: after[k] - before[k] for k in ("gram", "wsum")} == {
        "gram": 4, "wsum": 4}
    assert len(gram_chunks(shape[2])) == -(-shape[2] // GRAM_CHUNK)


@pytest.mark.cuda
@pytest.mark.parametrize("k, pad", [(5, 3), (5, 11), (13, 3)])
@pytest.mark.parametrize("d", [386, 2 * GRAM_CHUNK + 4])
def test_cuda_gram_pad_rows_leave_the_stack_alone(cuda, k, pad, d):
    """A stack runs on the smallest compiled height that holds it, and no
    pair of its own rows reads the height's pad rows: appending zero rows
    (within the one-role heights, up to 16) leaves the stack's block of G
    bit for bit."""
    x = torch.from_numpy(_stack((2, k, d), k + d)).to(cuda)
    gp = gram(torch.cat([x, x.new_zeros((2, pad, d))], 1))
    assert torch.equal(gp[:, :k, :k], gram(x))
    assert not gp[:, k:].any() and not gp[:, :, k:].any()


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
    with pytest.raises(ValueError, match="K <= 32"):
        weiszfeld_weights(torch.zeros((1, 33, 33), device=cuda), 1e-6, 4)
    with pytest.raises(ValueError, match="square"):
        weiszfeld_weights(torch.zeros((1, 4, 5), device=cuda), 1e-6, 4)
    with pytest.raises(TypeError, match="float32"):
        weiszfeld_weights(torch.zeros((1, 4, 4), device=cuda,
                                      dtype=torch.float64), 1e-6, 4)
    with pytest.raises(ValueError, match="contiguous"):
        weiszfeld_weights(torch.zeros((4, 4, 1), device=cuda
                                      ).transpose(0, 2), 1e-6, 4)
    with pytest.raises(ValueError, match="n_iter"):
        weiszfeld_weights(torch.zeros((1, 4, 4), device=cuda), 1e-6, -1)
    with pytest.raises(ValueError, match="nu"):
        weiszfeld_weights(torch.zeros((1, 4, 4), device=cuda), 0.0, 4)


def _grid(shape, seed):
    """Small integers: every sum is exact, so kernel and plain version
    must agree bit for bit."""
    return np.random.default_rng(seed).integers(-4, 5, shape).astype(
        np.float32)


def _nbr_tables(topology, K, seed):
    """The neighbour tables a case runs: a topology's, or, for "every P",
    random (K, P) tables (repeated neighbours included) for P = 1..32."""
    if topology != "every P":
        return [resolve_topology(topology, K).nbr_idx]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, K, (K, p)) for p in range(1, 33)]


def _with_specials(x):
    """A few coordinates with a NaN, a +inf and a -inf slot."""
    x = x.clone()
    x[..., 0, 1] = float("nan")
    x[..., -1, 2] = float("inf")
    x[..., 0, 3] = float("-inf")
    x[..., -1, 3] = float("inf")
    return x


# the main path's inputs, d not a multiple of 4 (67) and over several
# 256-coordinate blocks (1000), and every P in 1..32 at K = 13 and 32
@pytest.mark.cuda
@pytest.mark.parametrize("K,d,topology", [(13, 386, "complete"),
                                          (13, 386, "ring(k=4)"),
                                          (9, 1000, "complete"),
                                          (32, 300, "complete"),
                                          (13, 67, "every P"),
                                          (32, 1000, "every P")])
@pytest.mark.parametrize("grid", [False, True], ids=["normal", "grid"])
def test_cuda_cw_kernels_match_plain(cuda, K, d, topology, grid):
    make = _grid if grid else _stack
    x = torch.from_numpy(make((2, K, d), 9)).to(cuda)
    x[1, 3] = x[1, 5]                               # tied rows
    before = dispatch.launch_counts()

    def same(fn, plain, *args, tol):
        out = fn(*args)
        # fixed-order sums; NaN where the plain version has it
        torch.testing.assert_close(out, fn(*args), rtol=0, atol=0,
                                   equal_nan=True)
        torch.testing.assert_close(out, plain(*args), rtol=0,
                                   atol=0 if grid else tol, equal_nan=True)

    # the plain versions sum in the kernels' order: the tolerance is what
    # another order could cost, P·eps·max|x|
    eps = torch.finfo(torch.float32).eps
    g = gram(x)
    scale = krum_score_plain(g, K - 5).abs().max().item()
    same(krum_score, krum_score_plain, g, K - 5, tol=K * eps * scale)
    n_trim = (K - 1) // 4
    same(trimmed_mean, trimmed_mean_plain, x, n_trim,
         tol=K * eps * x.abs().max().item())
    tables = _nbr_tables(topology, K, d)
    for nbr in tables:
        nbr = torch.as_tensor(nbr, dtype=torch.int64, device=cuda)
        P = nbr.shape[1]
        msgs = x[0].contiguous()
        recv = torch.from_numpy(make((K, P, d), 10 + P)).to(cuda)
        if topology == "every P":
            msgs, recv = _with_specials(msgs), _with_specials(recv)
            # the trimmed mean over P agents, padded to a multiple of 8
            xs = _with_specials(torch.from_numpy(make((2, P, d), P)).to(
                cuda))
            scale_x = xs[xs.isfinite()].abs().max().item()
            for nt in sorted({0, (P - 1) // 4, (P - 1) // 2}):
                same(trimmed_mean, trimmed_mean_plain, xs, nt,
                     tol=P * eps * scale_x)
        scale_m = msgs[msgs.isfinite()].abs().max().item()
        scale_r = recv[recv.isfinite()].abs().max().item()
        for mode, nt in (("mean", 0), ("median", 0),
                         ("trimmed", (P - 1) // 2)):
            same(gossip_reduce, gossip_reduce_plain, msgs, nbr, mode, nt,
                 tol=P * eps * scale_m)
            same(neighbor_reduce, neighbor_reduce_plain, recv, mode, nt,
                 tol=P * eps * scale_r)
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    n = len(tables)
    n_tm = 2 + (sum(len({0, (p - 1) // 4, (p - 1) // 2})
                    for p in range(1, 33)) * 2 if n > 1 else 0)
    assert {k: after[k] - before[k] for k in CW + ("gram",)} == {
        "gram": 1, "krum_score": 2, "trimmed_mean": n_tm,
        "gossip_reduce": 6 * n, "neighbor_reduce": 6 * n}


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


#: stack heights at the edges of the weiszfeld and krum_score instances
#: (weiszfeld: 8, 16, 32; krum_score: the cw rank network's exact 5 and
#: 13, padded 8, 16, 32)
SWEEP_K = (1, 4, 5, 7, 8, 9, 13, 16, 17, 24, 32)


def _gram_cases(k, seed):
    """(name, G) of two Gram matrices each: normal rows, two duplicated
    rows (distance exactly 0), and an outlier row far from the rest."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, k, 96)).astype(np.float32) + 1.0
    dup = x.copy()
    dup[:, k - 1] = dup[:, 0]
    out = x.copy()
    out[:, k // 2] += 1e3
    return [(name, gram_plain(torch.from_numpy(v)))
            for name, v in (("normal", x), ("dups", dup), ("outlier", out))]


def _specials(g):
    """G with a NaN, +inf and -inf entries: some distances NaN or
    infinite, some rows all NaN."""
    g = g.clone()
    k = g.shape[-1]
    g[0, 0, k - 1] = float("nan")
    g[0, k - 1, k // 2] = float("inf")
    g[1, k // 2, k // 2] = float("inf")
    g[1, 0, k - 1] = float("-inf")
    g[1, k - 1, 0] = float("-inf")
    return g


def _same_bits(out, want, what):
    """Equal values, NaN where ``want`` has NaN (any NaN's bits)."""
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", SWEEP_K)
def test_cuda_weiszfeld_bit_equal_at_every_k(cuda, k):
    """The kernel at every instance edge equals its plain version bit for
    bit, for 0, 1 and 32 steps, on duplicated rows, an outlier row and G
    with NaN and infinite entries (NaN where the plain version gives
    NaN); reruns are bit-identical; one launch a call."""
    cases = _gram_cases(k, 100 + k)
    cases.append(("specials", _specials(cases[0][1])))
    before = dispatch.launch_counts()["weiszfeld"]
    calls = 0
    for name, g in cases:
        g = g.to(cuda)
        for n_iter in (0, 1, 32):
            w = weiszfeld_weights(g, 1e-6, n_iter)
            assert w.shape == (2, k) and w.dtype == torch.float32
            _same_bits(w, weiszfeld_weights(g, 1e-6, n_iter),
                       f"K={k} {name} n_iter={n_iter} rerun")
            _same_bits(w, weiszfeld_plain(g, 1e-6, n_iter),
                       f"K={k} {name} n_iter={n_iter}")
            calls += 2
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["weiszfeld"] - before == calls


@pytest.mark.cuda
@pytest.mark.parametrize("k", SWEEP_K)
def test_cuda_krum_score_bit_equal_at_every_k(cuda, k):
    """The kernel at every instance edge equals its plain version bit for
    bit at several n_near, on duplicated rows (tied distances), an outlier
    row and G with NaN and infinite entries: a NaN distance ranks 0 and
    is never kept, as in the plain version and the reference (CUDA's
    fmaxf would clamp it to a kept 0); reruns are bit-identical; one
    launch a call."""
    cases = _gram_cases(k, 200 + k)
    cases.append(("specials", _specials(cases[0][1])))
    before = dispatch.launch_counts()["krum_score"]
    calls = 0
    for name, g in cases:
        g = g.to(cuda)
        for n_near in sorted({1, max(k // 2, 1), max(k - 1, 1), k + 2}):
            s = krum_score(g, n_near)
            assert s.shape == (2, k) and s.dtype == torch.float32
            _same_bits(s, krum_score(g, n_near),
                       f"K={k} {name} n_near={n_near} rerun")
            _same_bits(s, krum_score_plain(g, n_near),
                       f"K={k} {name} n_near={n_near}")
            calls += 2
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["krum_score"] - before == calls


@pytest.mark.cuda
def test_cuda_krum_score_drops_nan_distances(cuda):
    """A NaN in G makes NaN distances, which rank 0 and are dropped: the
    scores equal the plain version's, and no NaN reaches them."""
    g = _gram_cases(13, 7)[0][1]
    g[0, 2, 5] = g[0, 5, 2] = float("nan")
    g[1, 3, 3] = float("nan")                 # row 3 of matrix 1: all NaN
    g = g.to(cuda)
    s = krum_score(g, 8)
    assert torch.equal(s, krum_score_plain(g, 8))
    assert torch.isfinite(s).all()
    assert s[1, 3] == 0.0                     # nothing kept


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
    (1, 10, 2, 100, 64),            # G = 5 (Hymba's)
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
    # a strided q (every other position of a longer one) is taken as it is
    q2 = torch.zeros((2, 80, 4, 64), device=cuda)
    q2[:, ::2] = q
    assert torch.equal(flash_attention(q2[:, ::2], k, v), out)
    # above 128 the kernel has no tiling (ROADMAP Queue 1 item 7)
    with pytest.raises(ValueError, match="head_dim up to 128.*Queue 1 item 7"):
        flash_attention_kernel(torch.zeros((2, 8, 192), device=cuda),
                               torch.zeros((2, 8, 192), device=cuda),
                               torch.zeros((2, 8, 192), device=cuda), 2)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(torch.zeros((2, 8, 48), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2)
    with pytest.raises(TypeError, match="float32"):
        flash_attention_kernel(torch.zeros((2, 8, 64), device=cuda,
                                           dtype=torch.float64),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2)
    # the head dim must be contiguous: rows are copied 16 bytes at a time
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_attention_kernel(torch.zeros((2, 64, 8), device=cuda
                                           ).transpose(1, 2),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2)
    with pytest.raises(ValueError, match="window"):
        flash_attention_kernel(torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2, 0)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_kernel(torch.zeros(2 * 8 * 64 + 1, device=cuda
                                           )[1:].view(2, 8, 64),
                               torch.zeros((2, 8, 64), device=cuda),
                               torch.zeros((2, 8, 64), device=cuda), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv", [(8, 8), (32, 8), (16, 2)])
@pytest.mark.parametrize("window", [None, 100])
def test_cuda_flash_attention_strided_layout_equals_folded(cuda, H, Hkv,
                                                           window):
    """G = 1, 4 and 8: q, k and v sliced out of one fused (B, S, H + 2Hkv,
    hd) projection go through the model-layout launch, their contiguous
    folded copies through the folded one; the two give the same bits."""
    rng = np.random.default_rng(14)
    B, S, hd = 2, 300, 64
    fused = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, hd)).astype(np.float32)).to(cuda)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + Hkv], fused[:, :, H + Hkv:]
    before = dispatch.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, window)
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    fold = [x.transpose(1, 2).reshape(B * x.shape[2], S, hd).contiguous()
            for x in (q, k, v)]
    folded = flash_attention_kernel(*fold, H, window)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] - before == 2
    assert torch.equal(got, folded.reshape(B, H, S, hd).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 48, 50, 96, 100])
@pytest.mark.parametrize("window", [None, 20])
def test_cuda_flash_attention_at_head_dims_it_pads(cuda, hd, window):
    """A head dim the kernel is not compiled for runs on the kernel,
    zero-padded to the next compiled one, in both layouts: against the
    plain version at the true head dim (tolerance 2e-5·max|v|), the
    model layout on strided views with the folded launch's bits."""
    B, H, Hkv, S = 2, 4, 2, 100
    q, k, v = (t.to(cuda) for t in _qkv(B, H, Hkv, S, S, hd, 15 + hd))
    before = dispatch.launch_counts()["flash_attention"]
    out = flash_attention_kernel(q, k, v, H, window)
    assert out.shape == q.shape and out.is_contiguous()
    assert torch.equal(out, flash_attention_kernel(q, k, v, H, window))
    torch.testing.assert_close(
        out, flash_attention_plain(q, k, v, H, window), rtol=0,
        atol=2e-5 * v.abs().max().item())
    fused = torch.cat([x.reshape(B, -1, S, hd).transpose(1, 2)
                       for x in (q, k, v)], 2)
    got = flash_attention(fused[:, :, :H], fused[:, :, H:H + Hkv],
                          fused[:, :, H + Hkv:], window)
    assert got.is_contiguous()
    assert torch.equal(got, out.reshape(B, H, S, hd).transpose(1, 2))
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] - before == 3


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["byzpg", "decbyzpg"])
def test_cuda_telemetry_is_bit_identical(cuda, algo):
    """Telemetry observes only, on the card too: the same seed's run with
    it on gives the same bits, one tap per iteration, and the rejection
    mask's kernels (Krum: gram and krum_score) on top of the run's own."""
    import dataclasses
    from repro_torch import obs
    from repro_torch.core.byzpg import ByzPGConfig, run_byzpg
    from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
    from repro_torch.rl.envs import make_cartpole
    kw = dict(K=13, n_byz=3, attack="large_noise(sigma=10)",
              aggregator="krum", N=8, B=2)
    cfg, run = ((ByzPGConfig(**kw), run_byzpg) if algo == "byzpg" else
                (DecByzPGConfig(**kw, agreement="cwtm"), run_decbyzpg))
    env = make_cartpole(horizon=32)
    T = 3
    off = run(env, cfg, T, device=cuda)
    before = dispatch.launch_counts()
    with obs.capture(algo) as sink:
        on = run(env, dataclasses.replace(cfg, telemetry=True), T,
                 device=cuda)
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    for k in ("returns", "coins") + (("diameter",) if algo == "decbyzpg"
                                     else ()):
        np.testing.assert_array_equal(on[k], off[k])
    carry = "vec" if algo == "byzpg" else "theta"
    assert torch.equal(on[carry], off[carry])
    assert [int(r["t"]) for r in sink.records] == list(range(T))
    assert on["rejected"].sum(1).tolist() == [3] * T
    own = {"gram": 1, "krum_score": 1} if algo == "byzpg" else \
        {"gram": 2, "krum_score": 1, "gossip_reduce": 6}
    assert {k: after[k] - before[k] for k in own} == \
        {k: (n + (k in ("gram", "krum_score"))) * T for k, n in own.items()}


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """Save from the card, restore onto it (and onto the CPU) bit for bit,
    and serve the restored policy parameters."""
    from repro_torch import checkpoint
    from repro_torch.core.registry import resolve
    from repro_torch.core.tree import tree_paths
    from repro_torch.serving import policy_params
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    tree = {"layers": [{"w": torch.randn(4, 3, generator=gen, device=cuda),
                        "b": torch.randn(3, generator=gen, device=cuda)}],
            "step": torch.arange(3, dtype=torch.int32, device=cuda)}
    checkpoint.save(tree, str(tmp_path / "c"))
    for dev in (cuda, "cpu", None):
        back = checkpoint.restore(tree, str(tmp_path / "c"), device=dev)
        for (k, a), (kb, b) in zip(tree_paths(tree), tree_paths(back)):
            assert k == kb and b.device.type == (
                "cpu" if dev == "cpu" else "cuda")
            assert torch.equal(a.cpu(), b.cpu())
    spec = "transformer(arch='llama3.2-1b', n_layers=2, d_model=64, n_heads=2)"
    pol = resolve("policy", spec, env=resolve("env", "cartpole(horizon=32)"))
    params = policy_params(pol, key=1, device=cuda)
    checkpoint.save(params, str(tmp_path / "p"))
    got = policy_params(pol, checkpoint=str(tmp_path / "p"))
    assert all(b.is_cuda and torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_paths(params), tree_paths(got)))
