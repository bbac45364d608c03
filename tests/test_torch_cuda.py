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
def test_cuda_weiszfeld_per_row_nu_bit_equal(cuda, k):
    """A (Bt,) ``nu``, another in every batch element (a lane group
    sweeping ``rfa(nu=...)``): bit-equal to the plain version and to each
    element's scalar call; a non-positive entry raises."""
    g = _gram_cases(k, 300 + k)[0][1].repeat(3, 1, 1).to(cuda)
    nus = torch.tensor([1e-6, 1e-3, 1e-1, 2.0, 5e-5, 7.0][:g.shape[0]],
                       device=cuda)
    w = weiszfeld_weights(g, nus, 32)
    _same_bits(w, weiszfeld_plain(g, nus, 32), f"K={k} per-row nu")
    for b in range(g.shape[0]):
        _same_bits(w[b], weiszfeld_weights(g[b:b + 1], float(nus[b]), 32)[0],
                   f"K={k} row {b} scalar nu")
    with pytest.raises(ValueError, match="every nu"):
        weiszfeld_weights(g, torch.zeros_like(nus), 4)


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
    # above 256 the kernel has no tiling (ROADMAP, Queue 2)
    with pytest.raises(ValueError, match="head_dim up to 256.*Queue 2"):
        flash_attention_kernel(torch.zeros((2, 8, 320), device=cuda),
                               torch.zeros((2, 8, 320), device=cuda),
                               torch.zeros((2, 8, 320), device=cuda), 2)
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
@pytest.mark.parametrize("hd", [8, 48, 50, 96, 100, 160, 200])
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


@pytest.mark.cuda
def test_cuda_windowed_sweep_equals_run_grid(cuda, tmp_path):
    """A two-window sweep on the card, preempted after its first window
    and resumed, equals ``run_grid`` on the card bit for bit (the CUDA
    generators' states carried across the archive), with the run's
    launches; a sweep started on the CPU refuses to resume on the card."""
    from repro_torch.core.engine import ScenarioGrid, run_grid
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.sweep import SweepMismatch, SweepRunner
    axes = {"aggregator": ("krum", "trimmed_mean")}
    kw = dict(K=13, n_byz=3, attack="large_noise(sigma=10)",
              agreement="cwtm", N=8, B=2)
    T, seeds = 4, (0, 1)
    ref = run_grid(make_cartpole(horizon=32), ScenarioGrid(seeds=seeds,
                                                           axes=axes),
                   T, algo="decbyzpg", device=cuda, **kw)
    out = str(tmp_path / "card")
    sweep = dict(algo="decbyzpg", env="cartpole(horizon=32)", T=T,
                 seeds=seeds, axes=axes, windows=2, **kw)
    before = dispatch.launch_counts()
    assert SweepRunner(out_dir=out, device=cuda, **sweep).run(
        max_windows=1) is None
    res = SweepRunner.resume(out).run()
    torch.cuda.synchronize()
    after = dispatch.launch_counts()
    for scn, want in ref.items():
        got = res[tuple(scn)]
        for k in ("returns", "samples", "diameter", "theta"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["final_return_mean"] == want["final_return_mean"]
    # Krum: gram 2, krum_score 1; the trimmed mean: gram 1, trimmed_mean 1;
    # cwtm's κ = 6 rounds each (consistent attack); each aggregator is a
    # lane group whose two seed rows launch one run's kernels a step
    per_iter = {"gram": 3, "krum_score": 1, "trimmed_mean": 1,
                "gossip_reduce": 12}
    assert {k: after[k] - before[k] for k in per_iter} == \
        {k: n * T for k, n in per_iter.items()}
    cpu_dir = str(tmp_path / "cpu")
    SweepRunner(out_dir=cpu_dir, device="cpu", **dict(
        sweep, T=2, seeds=(0,), axes={"aggregator": ("trimmed_mean",)})
    ).run(max_windows=1)
    with pytest.raises(SweepMismatch, match="meta.device: 'cpu' != 'cuda'"):
        SweepRunner.resume(cpu_dir).run()


#: the reference's tiny transformer policy (tests/test_policy.py)
TINY_TF = ("transformer(arch='qwen2.5-3b', d_model=32, n_layers=1, "
           "n_heads=2, d_ff=64)")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 12])
def test_cuda_chunked_attention_equals_the_cpu_route(cuda, window):
    """The training route on the card against the same computation on the
    CPU in float64: output and the gradients of q, k and v within 1e-4 of
    each tensor's largest entry (f32 on the card)."""
    from repro_torch.models.attention import chunked_causal_attention
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 40, 4, 16))
    k = rng.standard_normal((2, 40, 2, 16))
    v = rng.standard_normal((2, 40, 2, 16))
    ct = rng.standard_normal(q.shape)
    pos = torch.arange(40) + 7
    out = {}
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        ts = [torch.tensor(x, dtype=dt, device=dev, requires_grad=True)
              for x in (q, k, v)]
        o = chunked_causal_attention(*ts, pos.to(dev), pos.to(dev),
                                     window=window, chunk=16)
        (o * torch.tensor(ct, dtype=dt, device=dev)).sum().backward()
        out[str(dev)] = [o.detach()] + [t.grad for t in ts]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        err = (got.cpu().double() - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_transformer_decbyzpg_repeats_and_routes(cuda):
    """A tiny-transformer DecByzPG run on the card repeats bit for bit;
    the rollout and the gradient estimate take the chunked route and
    launch no flash attention, and serving's ``logits`` launches it once
    per layer."""
    from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
    from repro_torch.core.noise import draw_step_noise
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.gradient import grad_estimate
    from repro_torch.rl.policy import resolve_policy
    from repro_torch.rl.rollout import rollout
    env = make_cartpole(horizon=10)
    cfg = DecByzPGConfig(K=3, n_byz=1, attack="large_noise(sigma=10)",
                         aggregator="rfa", agreement="gda", kappa=1, N=3,
                         B=2, policy=TINY_TF)
    a = run_decbyzpg(env, cfg, 2, device=cuda)
    b = run_decbyzpg(env, cfg, 2, device=cuda)
    assert torch.equal(a["theta"], b["theta"])
    np.testing.assert_array_equal(a["returns"], b["returns"])
    assert np.isfinite(a["returns"]).all()
    policy = resolve_policy(cfg, env)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    theta = torch.stack([policy.init_theta(gen) for _ in range(cfg.K)])
    nz = draw_step_noise(gen, cfg, env, policy.d, 0)
    L = policy.model_cfg.n_layers
    before = dispatch.launch_counts()["flash_attention"]
    traj = rollout(env, policy, theta, nz.s0, nz.gumbel)
    torch.cuda.synchronize()
    mid = dispatch.launch_counts()["flash_attention"]
    g = grad_estimate(policy, theta, traj, cfg.gamma)
    torch.cuda.synchronize()
    after = dispatch.launch_counts()["flash_attention"]
    assert (mid - before, after - mid) == (0, 0)
    assert bool(torch.isfinite(g).all())
    policy.logits(policy.layers(theta[0]), traj.obs[0, :, 0])
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] - after == L


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 16, 77, 256])
def test_cuda_flash_attention_at_hymbas_served_shapes(cuda, S):
    """Hymba-1.5B's prefill: 25 query heads over 5 KV heads (G = 5, odd,
    not a divisor of the 64-row tile), hd 64, at exact prompt lengths
    (77 not a multiple of 64), in the model layout sliced out of one
    fused projection: against the plain version, tolerance 2e-5·max|v|,
    bit-equal on repeat, one launch per call."""
    rng = np.random.default_rng(S)
    H, Hkv, hd = 25, 5, 64
    fused = torch.from_numpy(rng.standard_normal(
        (1, S, H + 2 * Hkv, hd)).astype(np.float32)).to(cuda)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + Hkv], fused[:, :, H + Hkv:]
    before = dispatch.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v)
    assert torch.equal(out, flash_attention(q, k, v))
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] - before == 2
    fold = [x.transpose(1, 2).reshape(x.shape[2], S, hd).contiguous()
            for x in (q, k, v)]
    want = flash_attention_plain(*fold, H).reshape(1, H, S, hd)
    torch.testing.assert_close(out, want.transpose(1, 2), rtol=0,
                               atol=2e-5 * v.abs().max().item())


RECURRENT_ARCHS = ["hymba-1.5b", "xlstm-350m"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_cuda_recurrent_model_matches_the_cpu(cuda, arch):
    """A reduced Hymba-1.5B or xLSTM-350M on the card against the same
    weights on the CPU: a 37-token prefill and 4 decode steps, logits
    within 1e-4 (f32 sums in other orders), every state leaf within 1e-4
    of its largest entry; the prefill repeats bit for bit on the card;
    Hymba's prefill launches flash once per layer, xLSTM's none."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_paths
    from repro_torch.models.model import (decode_step, init_params, prefill,
                                          tree_map)
    cfg = reduced(get_config(arch))
    cpu_params = init_params(cfg, 5, device="cpu")
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 37)))
    before = dispatch.launch_counts()["flash_attention"]
    lg, cache = prefill(cfg, params, toks.to(cuda), cache_len=48)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_attention"] - before == (
        cfg.n_layers if cfg.family == "hybrid" else 0)
    again, cache2 = prefill(cfg, params, toks.to(cuda), cache_len=48)
    assert torch.equal(lg, again)
    for (_, a), (_, b) in zip(tree_paths(cache), tree_paths(cache2)):
        assert torch.equal(a, b)
    lc, ccache = prefill(cfg, cpu_params, toks, cache_len=48)
    tok = torch.argmax(lc[:, -1], -1)
    for _ in range(4):
        assert (lg.cpu() - lc).abs().max().item() <= 1e-4
        lg, cache = decode_step(cfg, params, tok.to(cuda), cache)
        lc, ccache = decode_step(cfg, cpu_params, tok, ccache)
        tok = torch.argmax(lc[:, 0], -1)
    assert (lg.cpu() - lc).abs().max().item() <= 1e-4
    for (path, a), (_, b) in zip(tree_paths(cache["blocks"]),
                                 tree_paths(ccache["blocks"])):
        scale = max(b[b > -1e29].abs().max().item(), 1.0)
        assert (a.cpu() - b)[b > -1e29].abs().max().item() <= 1e-4 * scale, \
            path


FED_TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                vocab_size=128, head_dim=16)


@pytest.mark.cuda
@pytest.mark.parametrize("K,d", [(4, 1 << 20), (3, 1000)])
def test_cuda_rowwise_optimizer_and_page_equal_the_stacked_form(cuda, K, d):
    """The federated trainers' memory-lean forms, one agent's row at a
    time, give the stacked forms' bits: Adam (a carried state at step 3,
    the aggregate broadcast as an expanded view) and the PAGE combination
    ``g_new − g_old + v``."""
    from repro_torch.distributed.fed_trainer import tree_opt_update
    from repro_torch.optim.optimizers import AdamState, adam
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    opt = adam(1e-3, maximize=False)
    p, m = rnd(K, d), 0.05 * rnd(K, d)
    v = (0.05 * rnd(K, d)) ** 2 + 1e-4
    s = AdamState(torch.full((K,), 3, dtype=torch.int32, device=cuda), m, v)
    g = rnd(d)[None].expand(K, d)
    want_p, want_s = opt.update(g, s, p)
    got_p, got_s = tree_opt_update(opt, g, s, p)
    assert torch.equal(got_p, want_p)
    for a, b in zip(got_s, want_s):
        assert torch.equal(a, b)
    g_new, g_old, vv = rnd(K, d), rnd(K, d), rnd(d)[None].expand(K, d)
    want = g_new - g_old + vv
    rows = torch.empty_like(g_new)
    for k in range(K):
        rows[k].copy_(g_new[k] - g_old[k] + vv[k])
    assert torch.equal(rows, want)


def _tiny_fed(aggregator, attack="large_noise(sigma=10)"):
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed import fed_trainer as ft
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")),
                              **FED_TINY)
    fed = ft.FedConfig(aggregator=aggregator, attack=attack, n_byz=1,
                       kappa=2, lr=1e-3)
    batches = [TokenPipeline(DataConfig(cfg.vocab_size, 16, 2, 4),
                             device="cpu").batch(t) for t in range(2)]
    return cfg, fed, ft, batches


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["rfa", "krum", "trimmed_mean"])
def test_cuda_flat_fed_step_matches_the_cpu(cuda, aggregator):
    """Two flat-trainer steps (coin 1, then 0) on the card and on the CPU
    from the same weights and draws: θ within 1e-5 of its largest entry
    (f32 sums in other orders)."""
    cfg, fed, ft, batches = _tiny_fed(aggregator)
    from repro_torch.core.tree import tree_map
    cpu_st, unravel = ft.init_flat_fed_state(cfg, fed, 4, 0, device="cpu")
    gpu_st = tree_map(lambda x: x.to(cuda), cpu_st)
    mask = torch.arange(4) < 1
    gen = torch.Generator()
    gen.manual_seed(3)
    for t, b in enumerate(batches):
        nz = ft.fed_noise(gen, fed, cpu_st, 1)
        cpu_st, cm = ft.fed_train_step_flat(cfg, fed, cpu_st, unravel, b,
                                            mask, nz, large=t == 0)
        gpu_st, gm = ft.fed_train_step_flat(
            cfg, fed, gpu_st, unravel, {k: v.to(cuda) for k, v in b.items()},
            mask.to(cuda), type(nz)(*(None if x is None else x.to(cuda)
                                      for x in nz)), large=t == 0)
        assert abs(cm["loss"].item() - gm["loss"].item()) <= 1e-5
    scale = cpu_st.theta.abs().max()
    torch.testing.assert_close(gpu_st.theta.cpu(), cpu_st.theta, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("aggregator,want", [
    ("rfa", {"gram": 1, "weiszfeld": 1, "wsum": 1}),
    ("krum", {"gram": 1, "krum_score": 1}),
    ("trimmed_mean", {"trimmed_mean": 1})])
def test_cuda_flat_fed_step_launches(cuda, aggregator, want, telemetry):
    """Per flat step: bucketed RFA (2 buckets of 2 at K = 4, n_byz = 1)
    gram, weiszfeld and wsum once each, Krum gram and krum_score, the
    trimmed mean its kernel; with telemetry the rejection mask adds
    Krum's gram and krum_score once more (RFA's and the trimmed mean's
    masks launch none); the tree trainer launches none."""
    import dataclasses
    cfg, fed, ft, batches = _tiny_fed(aggregator)
    fed = dataclasses.replace(fed, telemetry=telemetry)
    if telemetry and aggregator == "krum":
        want = {"gram": 2, "krum_score": 2}
    st, unravel = ft.init_flat_fed_state(cfg, fed, 4, 0, device=cuda)
    tree_st = ft.init_fed_state(cfg, fed, 4, 0, device=cuda)
    mask = torch.arange(4, device=cuda) < 1
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for t, b in enumerate(batches):
        b = {k: v.to(cuda) for k, v in b.items()}
        dispatch.reset_launches()
        st, _ = ft.fed_train_step_flat(cfg, fed, st, unravel, b, mask,
                                       ft.fed_noise(gen, fed, st, 1),
                                       large=t == 0)
        counts = dispatch.launch_counts()
        assert counts == {n: want.get(n, 0) for n in counts}
        dispatch.reset_launches()
        tree_st, _ = ft.fed_train_step(cfg, fed, tree_st, b, mask,
                                       ft.fed_noise(gen, fed, tree_st, 1),
                                       large=t == 0)
        assert not any(dispatch.launch_counts().values())


def _launches_of(fn):
    """fn's result and the kernel launches it made."""
    dispatch.reset_launches()
    out = fn()
    return out, dispatch.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("spec,n_byz", [("rfa", 1), ("rfa", 0), ("krum", 0),
                                        ("krum", 1), ("trimmed_mean", 1)])
def test_cuda_sharded_route_on_one_process_is_bit_equal(cuda, spec, n_byz):
    """``sharded=True`` on a plain (K, D) stack is the D-sharded flat
    layer with one shard: at D = 3,000,001 (a ragged last ``gram``
    chunk) and K = 4, bucketed (n_byz 1: Lemma 3) and not, the same bits
    as the unsharded route with the same kernel launches."""
    from repro_torch.core.registry import resolve
    x = torch.from_numpy(_stack((4, 3_000_001), 31)).to(cuda)
    x[0] *= 10.0
    perm = torch.tensor([[2, 0, 3, 1]], device=cuda)
    dense = resolve("aggregator", spec, K=4, n_byz=n_byz)
    sharded = resolve("aggregator", spec, K=4, n_byz=n_byz, sharded=True)
    want, n_want = _launches_of(lambda: dense(x, perm))
    got, n_got = _launches_of(lambda: sharded(x, perm))
    assert torch.equal(got, want)
    assert n_got == n_want and sum(n_got.values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cwtm", "mda"])
def test_cuda_sharded_avg_agree_on_one_process_is_bit_equal(cuda, method):
    """``avg_agree(sharded=True)`` on a plain θ: the unsharded rounds'
    bits and kernels (``gossip_reduce`` for cwtm, ``gram`` for MDA),
    under a consistent ``large_noise`` attack."""
    import functools
    from repro_torch.core.agreement import avg_agree
    from repro_torch.core.attacks import large_noise
    K, d, kappa = 6, 100_003, 3
    theta = torch.from_numpy(_stack((K, d), 32)).to(cuda)
    noise = torch.from_numpy(_stack((kappa, K, d), 33, 0.0)).to(cuda)
    mask = torch.arange(K, device=cuda) < 1
    attack = functools.partial(large_noise, sigma=10.0)
    runs = [_launches_of(lambda: avg_agree(theta, kappa, 1, mask, method,
                                           attack, noise, sharded=s))
            for s in (None, True)]
    (want, n_want), (got, n_got) = runs
    assert torch.equal(got, want)
    kernel = "gossip_reduce" if method == "cwtm" else "gram"
    assert n_got == n_want and n_got[kernel] == kappa


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["rfa", "krum", "trimmed_mean"])
def test_cuda_one_rank_mesh_tree_step_is_bit_equal(cuda, aggregator):
    """``make_fed_step`` on a one-rank ("data", "model") = (1, 1) mesh on
    the card (a gloo group of one process): two tree steps (coin 1, then
    0) under ``large_noise`` the plain ``fed_train_step``'s bits, state
    and metrics, with no collective and no kernel launch (the tree rules
    are plain)."""
    import socket
    import torch.distributed as dist
    from repro_torch.core.tree import tree_paths
    from repro_torch.carriers import placed
    from repro_torch.launch.mesh import make_debug_mesh
    cfg, fed, ft, batches = _tiny_fed(aggregator)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        steps = {c: ft.make_fed_step(cfg, fed, mesh, large=c)[0]
                 for c in (True, False)}
        mask = torch.arange(4, device=cuda) < 1
        plain = ft.init_fed_state(cfg, fed, 4, 0, device=cuda)
        mesh_st = ft.place_fed_state(plain, mesh, cfg)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        for t, b in enumerate(batches):
            b = {k: v.to(cuda) for k, v in b.items()}
            nz = ft.fed_noise(gen, fed, plain, 1)
            plain, pm = ft.fed_train_step(cfg, fed, plain, b, mask, nz,
                                          large=t == 0)
            dispatch.reset_launches()
            mesh_st, mm = steps[t == 0](mesh_st, b, mask, nz)
            assert not any(dispatch.launch_counts().values())
            assert all(torch.equal(pm[k], mm[k]) for k in pm)
        for (_, a), (_, c) in zip(tree_paths(plain), tree_paths(mesh_st)):
            assert torch.equal(a, placed.local(c))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_one_rank_mesh_serving_is_bit_equal(cuda):
    """Reduced Llama-3.2-1B through ``make_serve_fns`` on a one-rank
    ("data", "model") = (1, 1) mesh on the card (a gloo group of one
    process): the prefill and three greedy decode steps bit-equal to
    ``model.prefill`` and ``decode_step`` on the same tensors, logits and
    every cache leaf, with the prefill's flash launches (one a layer)
    those of the plain route."""
    import socket
    import torch.distributed as dist
    from repro_torch.carriers import placed
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_paths
    from repro_torch.distributed.serving import make_serve_fns
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as tm
    cfg = reduced(get_config("llama3.2-1b"))
    params = tm.init_params(cfg, 0, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=cuda, dtype=torch.int32)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        fns = make_serve_fns(cfg, make_debug_mesh(1, 1, device_type="cuda"),
                             2, 48)
        dispatch.reset_launches()
        logits, cache = fns.prefill(params, toks)
        n_mesh = dispatch.launch_counts()["flash_attention"]
        dispatch.reset_launches()
        want, wcache = tm.prefill(cfg, params, toks, cache_len=48)
        assert n_mesh == dispatch.launch_counts()["flash_attention"] \
            == cfg.n_layers
        for _ in range(4):
            assert torch.equal(placed.local(logits), want)
            tok = want[:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = fns.decode(params, tok, cache)
            want, wcache = tm.decode_step(cfg, params, tok, wcache)
        assert torch.equal(placed.local(logits), want)
        for (_, a), (_, b) in zip(tree_paths(cache), tree_paths(wcache)):
            assert torch.equal(placed.local(a), b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hd_v", [(192, 128), (192, 192), (256, 256),
                                     (96, 64), (160, 100), (256, 64)])
@pytest.mark.parametrize("window", [None, 40])
def test_cuda_flash_attention_wide_and_a_narrower_v(cuda, hd, hd_v,
                                                    window):
    """The wide instances (32-key tiles) and v's own head dim (MLA's 192/128
    and 96/64), ragged S over several tiles, G = 1 and 4: against the
    plain version (2e-5·max|v|), rerun bit-identical, the model layout
    on strided views with the folded launch's bits."""
    B, S = 2, 150
    for H, Hkv in ((4, 4), (8, 2)):
        rng = np.random.default_rng(hd + hd_v + H)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda) for shape in (
            (B * H, S, hd), (B * Hkv, S, hd), (B * Hkv, S, hd_v)))
        before = dispatch.launch_counts()["flash_attention"]
        out = flash_attention_kernel(q, k, v, H, window)
        assert out.shape == (B * H, S, hd_v) and out.is_contiguous()
        assert torch.equal(out, flash_attention_kernel(q, k, v, H, window))
        torch.testing.assert_close(
            out, flash_attention_plain(q, k, v, H, window), rtol=0,
            atol=2e-5 * v.abs().max().item())
        got = flash_attention(*(x.reshape(B, -1, S, x.shape[-1])
                                .transpose(1, 2) for x in (q, k, v)),
                              window)
        assert torch.equal(got, out.reshape(B, H, S, hd_v).transpose(1, 2))
        torch.cuda.synchronize()
        assert dispatch.launch_counts()["flash_attention"] - before == 3
