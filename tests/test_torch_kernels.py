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
from repro.kernels.rfa.rfa import rfa_pallas  # noqa: E402

from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.pairwise_dist import (  # noqa: E402
    GRAM_CHUNK, gram, gram_chunks, gram_plain, pairwise_sq_dists)
from repro_torch.kernels.rfa import (  # noqa: E402
    rfa, weighted_sum, weighted_sum_plain, weiszfeld_plain,
    weiszfeld_weights)

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
