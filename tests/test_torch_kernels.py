"""The port's kernels: plain versions against the JAX package's Pallas
bodies (interpret mode) and oracles, and the device routing. The CUDA
kernels themselves are held against the plain versions on a GPU by
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.pairwise_dist.pairwise_dist import (  # noqa: E402
    gram as jax_gram, pairwise_sq_dists_pallas)
from repro.kernels.rfa import ref as rfa_ref  # noqa: E402
from repro.kernels.krum_score.krum_score import (  # noqa: E402
    krum_scores_pallas)
from repro.kernels.rfa.rfa import rfa_pallas  # noqa: E402

from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.pairwise_dist import (  # noqa: E402
    GRAM_CHUNK, gram, gram_chunks, gram_plain, pairwise_sq_dists)
from repro_torch.kernels.gossip_reduce.cw_reduce import (  # noqa: E402
    cw_instance)
from repro_torch.kernels.krum_score import krum_scores  # noqa: E402
from repro_torch.kernels.rfa import (  # noqa: E402
    rfa, weighted_sum, weighted_sum_plain, weiszfeld_instance,
    weiszfeld_plain, weiszfeld_weights)
from repro_torch.kernels.rfa.rfa import (  # noqa: E402
    WEISZFELD_HEIGHTS, tree_sum)

torch.set_num_threads(2)

SHAPES = [(1, 1, 17), (3, 5, 300), (2, 13, 1000), (1, 16, 2048)]


def _stack(shape, seed=0, offset=1.5):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) + offset


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_and_distances_match_pallas(shape):
    x = _stack(shape)
    g = gram_plain(torch.from_numpy(x)).numpy()
    d2 = pairwise_sq_dists(torch.from_numpy(x)).numpy()
    for b in range(shape[0]):
        want_g = np.asarray(jax_gram(jnp.asarray(x[b]), interpret=True))
        want_d2 = np.asarray(pairwise_sq_dists_pallas(jnp.asarray(x[b]),
                                                      interpret=True))
        # f32 sums over d in another order: relative to the Gram scale
        scale = np.abs(want_g).max()
        np.testing.assert_allclose(g[b], want_g, rtol=1e-5,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(d2[b], want_d2, rtol=1e-5,
                                   atol=1e-5 * scale)
        assert (d2[b] >= 0).all()


@pytest.mark.parametrize("d", [1, 386, GRAM_CHUNK, GRAM_CHUNK + 1,
                               3 * GRAM_CHUNK + 5])
def test_gram_chunk_plan_covers_d_exactly(d):
    starts = gram_chunks(d)
    plan = [(lo, min(lo + starts.step, d)) for lo in starts]
    assert plan[0][0] == 0 and plan[-1][1] == d
    for (lo, hi), (lo2, _) in zip(plan, plan[1:]):
        assert hi == lo2                            # no gap, no overlap
    assert all(0 < hi - lo <= GRAM_CHUNK for lo, hi in plan)
    assert all(hi - lo == GRAM_CHUNK for lo, hi in plan[:-1])
    assert len(plan) == -(-d // GRAM_CHUNK)


def test_chunked_gram_plain_matches_pallas():
    shape = (2, 13, 3 * GRAM_CHUNK + 5)
    x = _stack(shape, 14)
    g = gram_plain(torch.from_numpy(x))
    assert len(gram_chunks(shape[2])) == 4
    assert torch.equal(g, g.transpose(1, 2))        # each pair once
    for b in range(shape[0]):
        want = np.asarray(jax_gram(jnp.asarray(x[b]), interpret=True))
        np.testing.assert_allclose(g[b].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("d", [5, 387, 1001, 4867])
def test_weighted_sum_plain_at_unaligned_widths(d):
    """d % 4 != 0, the kernel's scalar route: against the reference's
    Pallas weighted sum (RFA with no Weiszfeld step, w = 1/K) and against
    float64 at other weights."""
    x = _stack((13, d), 15)
    z = weighted_sum_plain(torch.from_numpy(x)[None],
                           torch.full((1, 13), 1 / 13))[0].numpy()
    want = np.asarray(rfa_pallas(jnp.asarray(x), n_iter=0, interpret=True))
    scale = np.abs(x).max()
    np.testing.assert_allclose(z, want, rtol=0, atol=1e-5 * scale)
    w = np.random.default_rng(16).dirichlet(np.ones(13)).astype(np.float32)
    z = weighted_sum_plain(torch.from_numpy(x)[None],
                           torch.from_numpy(w)[None])[0].numpy()
    np.testing.assert_allclose(z, w.astype(np.float64) @ x, rtol=0,
                               atol=1e-5 * scale)


def _rfa_cases():
    rng = np.random.default_rng(1)
    dup = np.repeat(rng.standard_normal((1, 64)), 5, 0).astype(np.float32)
    outlier = np.concatenate([np.ones((6, 64)), np.full((1, 64), 1e3)]
                             ).astype(np.float32)
    return [("single", _stack((1, 40), 2)), ("k5", _stack((5, 300), 3)),
            ("k13", _stack((13, 386), 4)), ("dups", dup),
            ("outlier", outlier)]


@pytest.mark.parametrize("name,x", _rfa_cases(),
                         ids=[c[0] for c in _rfa_cases()])
@pytest.mark.parametrize("n_iter", [1, 32])
def test_rfa_matches_pallas_and_oracle(name, x, n_iter):
    z = rfa(torch.from_numpy(x)[None], n_iter=n_iter).numpy()[0]
    want = np.asarray(rfa_pallas(jnp.asarray(x), n_iter=n_iter,
                                 interpret=True))
    oracle = np.asarray(rfa_ref.rfa(jnp.asarray(x), n_iter=n_iter))
    scale = max(float(np.abs(want).max()), 1.0)
    # the same Gram-space algorithm: summation order only
    np.testing.assert_allclose(z, want, atol=1e-5 * scale)
    # the direct-space oracle loses a few bits less to cancellation
    # (tests/test_kernels.py::test_rfa_sweep's bound)
    np.testing.assert_allclose(z, oracle, atol=2e-4 * scale)
    if name == "outlier" and n_iter == 32:
        assert np.abs(z - 1.0).max() < 1e-2


def test_rfa_batch_is_per_element():
    """No batch element leaks into another: each agrees with its own
    single-element call (to rounding, as vectorized sums may split
    differently)."""
    x = torch.from_numpy(_stack((4, 7, 50), 5))
    x[2] += 100.0
    z = rfa(x)
    for b in range(4):
        torch.testing.assert_close(z[b], rfa(x[b:b + 1])[0], rtol=0,
                                   atol=1e-6 * x[b].abs().max().item())


def test_weiszfeld_and_wsum_plain_semantics():
    x = torch.from_numpy(_stack((2, 6, 30), 6))
    w = weiszfeld_plain(gram_plain(x), 1e-6, 0)
    torch.testing.assert_close(w, torch.full((2, 6), 1 / 6))
    torch.testing.assert_close(weighted_sum_plain(x, w), x.mean(1))
    with pytest.raises(ValueError, match="n_iter"):
        weiszfeld_plain(gram_plain(x), 1e-6, -1)


#: stack heights at the edges of the CUDA weiszfeld instances (8, 16, 32)
#: and krum_score's (exact 5 and 13; padded 8, 16, 32)
EDGE_K = (1, 5, 7, 8, 9, 13, 16, 17, 32)


def _tree_np(v):
    """The kernel's halving tree over the last axis, in numpy float32: pad
    with -0.0 to a power of two, then slot i += slot i + h."""
    n = v.shape[-1]
    p = 1 << (n - 1).bit_length()
    pad = np.full(v.shape[:-1] + (p - n,), -0.0, np.float32)
    v = np.concatenate([v, pad], -1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _weiszfeld_np(g, nu, n_iter):
    """Smoothed Weiszfeld in numpy float32, one IEEE operation at a time in
    the order the CUDA kernel takes them."""
    f32 = np.float32
    k = g.shape[-1]
    diag = np.diagonal(g, axis1=-2, axis2=-1)
    w = np.full(g.shape[:-1], f32(1) / f32(k), f32)
    with np.errstate(invalid="ignore"):          # inf - inf is NaN, meant
        for _ in range(n_iter):
            gw = _tree_np(g * w[..., None, :])
            wgw = _tree_np(w * gw)[..., None]
            x = (diag - f32(2) * gw) + wgw
            d2 = np.where(x < 0, f32(0), x)
            iw = f32(1) / np.sqrt(d2 + f32(nu))
            w = iw / _tree_np(iw)[..., None]
    return w


def _edge_stacks(k, seed, dup=True):
    """(2, k, 48): normal rows, then an outlier row and (``dup``) a
    duplicated row."""
    x = _stack((2, k, 48), seed)
    if dup:
        x[1, k - 1] = x[1, 0]
    x[1, k // 2] += 100.0
    return x


@pytest.mark.parametrize("k", EDGE_K)
@pytest.mark.parametrize("n_iter", [0, 1, 32])
def test_weiszfeld_plain_is_the_kernel_order_bit_for_bit(k, n_iter):
    """weiszfeld_plain equals a numpy float32 loop of the same operations
    in the same order bit for bit, also where G holds NaN and infinite
    entries (NaN in the same places)."""
    g = gram_plain(torch.from_numpy(_edge_stacks(k, 30 + k)))
    g[0, 0, k - 1] = float("nan")
    g[0, k - 1, k // 2] = float("inf")
    g = torch.cat([gram_plain(torch.from_numpy(_stack((1, k, 48), k))), g])
    got = weiszfeld_plain(g, 1e-6, n_iter).numpy()
    want = _weiszfeld_np(g.numpy(), 1e-6, n_iter)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got[0]).all()


def test_tree_sum_bits_do_not_depend_on_the_padding():
    """-0.0 pads add exactly to every value, -0.0 included: the sum over
    any power of two >= n slots has the same bits."""
    v = torch.from_numpy(_stack((4, 13), 40, 0.0))
    v[1, 3] = -0.0
    v[2] = -0.0
    v[3, 5] = float("nan")
    want = tree_sum(v)
    for p in (16, 32, 64):
        padded = torch.nn.functional.pad(v, (0, p - 13), value=-0.0)
        assert torch.equal(tree_sum(padded)[:3], want[:3])
        assert torch.isnan(tree_sum(padded)[3])
    assert torch.signbit(want[2])                 # a sum of -0.0 is -0.0


@pytest.mark.parametrize("k", EDGE_K)
def test_rfa_and_krum_match_pallas_at_every_k(k):
    """rfa and krum_scores of the port against the Pallas bodies in
    interpret mode at every instance edge, with the tolerances of the
    tests above: 1e-5·scale for RFA, SCORE_RTOL (1e-5 of the largest
    score) for Krum. RFA's stacks hold no duplicated row: a duplicate's
    distance is exactly 0 in one summation order and a cancellation
    residue of about eps·max|G| (far above nu) in another, which moves
    the smoothed weights by more than 1e-5 whichever order the port takes
    (3e-5·scale at K = 5 before and after the kernel's order changed); the
    bit tests on the card cover duplicates."""
    x = _edge_stacks(k, 50 + k, dup=False)
    z = rfa(torch.from_numpy(x), n_iter=32).numpy()
    x_dup = _edge_stacks(k, 50 + k)
    s = krum_scores(torch.from_numpy(x_dup), max(k - 3, 1)).numpy()
    for b in range(2):
        want = np.asarray(rfa_pallas(jnp.asarray(x[b]), n_iter=32,
                                     interpret=True))
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(z[b], want, atol=1e-5 * scale)
        want = np.asarray(krum_scores_pallas(jnp.asarray(x_dup[b]),
                                             max(k - 3, 1), interpret=True))
        np.testing.assert_allclose(s[b], want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30))


def test_weiszfeld_and_krum_height_plans():
    """Every K in 1..32 runs on the smallest compiled height that holds
    it: weiszfeld's padded 8, 16 or 32; krum_score's the cw rank
    network's (exact 5 and 13, padded 8, 16, 32). Outside 1..32 both
    raise."""
    for k in range(1, 33):
        h = weiszfeld_instance(k)
        assert h == min(x for x in WEISZFELD_HEIGHTS if x >= k), (k, h)
    assert [weiszfeld_instance(k) for k in (1, 5, 7, 8, 9, 13, 14, 16, 17,
                                            32)] == \
        [8, 8, 8, 8, 16, 16, 16, 16, 32, 32]
    assert [cw_instance(k) for k in (1, 5, 7, 8, 9, 13, 14, 16, 17, 32)] \
        == [8, 5, 8, 8, 16, 13, 16, 16, 32, 32]
    for bad in (0, 33):
        with pytest.raises(ValueError, match="K <= 32"):
            weiszfeld_instance(bad)
    with pytest.raises(ValueError, match="P <= 32"):
        cw_instance(33)


def test_cpu_tensors_take_the_plain_route():
    dispatch.reset_launches()
    x = torch.from_numpy(_stack((2, 5, 40), 7))
    g = gram(x)
    w = weiszfeld_weights(g, 1e-6, 8)
    z = weighted_sum(x, w)
    assert torch.equal(g, gram_plain(x))
    assert torch.equal(w, weiszfeld_plain(g, 1e-6, 8))
    assert torch.equal(z, weighted_sum_plain(x, w))
    # only the kernels called here: other test files on the same worker
    # may have registered more
    counts = dispatch.launch_counts()
    assert {k: counts[k] for k in ("gram", "weiszfeld", "wsum")} == {
        "gram": 0, "weiszfeld": 0, "wsum": 0}


def test_other_devices_have_no_route():
    with pytest.raises(ValueError, match="no route"):
        gram(torch.empty((1, 2, 3), device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    # one library for every source; its name follows all of them, so an
    # edit of any source rebuilds
    assert _build.library_path().name.startswith("libkernels-")
    assert [p.name for p in _build.sources()] == ["aggregation.cu",
                                                  "attention.cu",
                                                  "cw_reduce.cu"]
