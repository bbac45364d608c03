"""The port's flash attention on the CPU: its plain version (the CUDA
kernel's algorithm in PyTorch) against the JAX package's Pallas body in
interpret mode and its oracle, the model-layout wrapper against the
reference's, and the op's boundaries. The CUDA kernel itself is held
against the plain version on a GPU by ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_pallas)

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    BLOCK_Q)

torch.set_num_threads(2)

#: the reference's own tolerance for its f32 flash kernel tests
TOL = 2e-5


def _qkv(B, H, Hkv, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B * H, Sq, hd), (B * Hkv, Sk, hd), (B * Hkv, Sk, hd))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# tests/test_kernels.py's sweep, f32
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd", [
    (1, 2, 1, 64, 64, 16),
    (2, 4, 2, 96, 96, 32),
    (1, 8, 8, 128, 128, 64),
    (2, 4, 1, 100, 100, 24),        # ragged seq + GQA 4:1
    (1, 10, 2, 70, 70, 16),         # G = 5 (Hymba's)
    (1, 8, 1, 90, 90, 32),          # G = 8 (Qwen2.5-3B's)
    (2, 6, 3, 40, 40, 16),          # G = 2, batched
])
def test_plain_matches_pallas_and_oracle(B, H, Hkv, Sq, Sk, hd):
    q, k, v = _qkv(B, H, Hkv, Sq, Sk, hd)
    got = flash_attention_plain(*_t(q, k, v), H).numpy()
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), n_q_heads=H, block_q=32,
                                    block_k=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)
    oracle = fa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              n_q_heads=H)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL)


@pytest.mark.parametrize("window,H,Hkv", [
    (1, 2, 2), (7, 2, 2), (32, 2, 2), (1000, 2, 2),
    (7, 10, 2),                     # G = 5
    (32, 8, 1),                     # G = 8
    (5, 4, 1),                      # G = 4
    (20, 4, 2),                     # G = 2
], ids=["1", "7", "32", "1000", "7-G5", "32-G8", "5-G4", "20-G2"])
def test_plain_sliding_window_matches_pallas(window, H, Hkv):
    S, hd = 80, 16
    q, k, v = _qkv(1, H, Hkv, S, S, hd, seed=1)
    got = flash_attention_plain(*_t(q, k, v), H, window).numpy()
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), n_q_heads=H,
                                    window=window, block_q=16, block_k=16,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)


@pytest.mark.parametrize("B,H,Hkv,S,hd,window", [
    (1, 8, 1, 200, 32, None),       # G = 8, four q tiles
    (1, 4, 2, 200, 16, 70),         # window skips whole KV tiles
    (2, 2, 2, 9, 32, 128),          # the policy's prefill shape
    (1, 10, 2, 150, 32, 70),        # G = 5, window across tiles
    (2, 8, 2, 77, 16, None),        # G = 4, ragged last tile
    (1, 4, 2, 130, 16, 3),          # G = 2, narrow window
])
def test_plain_tiles_and_windows_match_oracle(B, H, Hkv, S, hd, window):
    q, k, v = _qkv(B, H, Hkv, S, S, hd, seed=2)
    got = flash_attention_plain(*_t(q, k, v), H, window).numpy()
    oracle = fa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              n_q_heads=H, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL)


def test_plain_with_fewer_keys_follows_the_oracle():
    """Sk < Sq: queries past the last key see every key. The port masks
    ``k_pos < Sk`` as the oracle does; the Pallas body, which pads Sk to
    its blocks, also weighs the zero padding there (ROADMAP Queue 3)."""
    q, k, v = _qkv(1, 2, 2, 40, 20, 16, seed=6)
    got = flash_attention_plain(*_t(q, k, v), 2).numpy()
    oracle = fa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              n_q_heads=2)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), n_q_heads=2, block_q=16,
                                    block_k=16, interpret=True)
    assert np.abs(np.asarray(pallas) - np.asarray(oracle)).max() > 0.1


@pytest.mark.parametrize("H,Hkv,Sq,Sk,window", [
    (2, 2, 30, 75, None),           # G = 1, more keys than queries
    (8, 2, 75, 30, None),           # G = 4, fewer keys
    (10, 2, 50, 90, 16),            # G = 5, window
    (8, 1, 90, 50, 60),             # G = 8, window, fewer keys
])
def test_plain_unequal_lengths_match_oracle(H, Hkv, Sq, Sk, window):
    """Sq != Sk on absolute positions, at G = 1, 4, 5 and 8; with
    Sq <= Sk the Pallas body (whose key padding lies past
    every query) agrees as well."""
    q, k, v = _qkv(1, H, Hkv, Sq, Sk, 16, seed=7)
    got = flash_attention_plain(*_t(q, k, v), H, window).numpy()
    oracle = fa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              n_q_heads=H, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL)
    if Sq <= Sk:
        pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), n_q_heads=H,
                                        window=window, block_q=16,
                                        block_k=16, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)


@pytest.mark.parametrize("G", [1, 2, 4, 5, 8])
def test_model_layout_matches_reference_over_groups(G):
    """The model-layout route at every GQA group of ``configs/`` (5 is
    Hymba's, 8 Qwen2.5-3B's), over two query tiles with a window across
    them, against the reference's model-layout wrapper."""
    rng = np.random.default_rng(9)
    B, S, Hkv, hd, window = 1, BLOCK_Q + 11, 2, 16, 40
    H = G * Hkv
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    got = flash_attention(*_t(q, k, v), window)
    assert got.shape == (B, S, H, hd)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=window,
                                   use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("H,Hkv,window", [(4, 4, None), (8, 2, 7),
                                          (10, 2, None), (8, 1, 33)])
def test_layout_route_equals_folded_route(H, Hkv, window):
    """The model-layout entry on strided views (q, k and v sliced out of
    one fused projection, as a QKV matmul gives them) returns the folded
    route's bits, unfolded."""
    rng = np.random.default_rng(8)
    B, S, hd = 2, 70, 16
    fused = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, hd)).astype(np.float32))
    q, k, v = fused[:, :, :H], fused[:, :, H:H + Hkv], fused[:, :, H + Hkv:]
    assert not q.is_contiguous()
    got = flash_attention_kernel(q, k, v, window=window)
    assert got.shape == (B, S, H, hd)
    fold = [x.transpose(1, 2).reshape(B * x.shape[2], S, hd).contiguous()
            for x in (q, k, v)]
    folded = flash_attention_kernel(*fold, H, window)
    assert torch.equal(got, folded.reshape(B, H, S, hd).transpose(1, 2))
    assert torch.equal(flash_attention(q, k, v, window), got)


def test_model_layout_wrapper_matches_reference():
    rng = np.random.default_rng(3)
    B, S, H, Hkv, hd = 2, 64, 4, 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    got = flash_attention(*_t(q, k, v))
    assert got.shape == (B, S, H, hd)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("hd", [8, 48, 50, 96])
@pytest.mark.parametrize("S", [128, 130])
def test_plain_on_zero_padded_head_dims_gives_the_same_result(hd, S):
    """What the CUDA route does at a head dim it was not compiled for: q,
    k and v zero-padded to the next compiled head dim, the true
    ``hd**-0.5`` passed in, the output sliced back. Zero columns add
    nothing to q·k and give only output columns that are sliced away, so
    on whole 64 x 64 tiles the plain version gives the same bits. On a
    ragged last tile (S = 130: two positions, a 4-row tile against 2
    keys at G = 2) MKL's small-matrix products sum a short head dim in
    another order than a padded one (at hd 48 and 50): there it agrees to
    f32 rounding, 1e-6·max|v|."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_head_dim)
    H, Hkv, B = 4, 2, 1
    q, k, v = _t(*_qkv(B, H, Hkv, S, S, hd, seed=hd))
    hd_k = kernel_head_dim(hd)
    assert hd_k == {8: 32, 48: 64, 50: 64, 96: 128}[hd]
    pad = (0, hd_k - hd)
    padded = flash_attention_plain(
        *(torch.nn.functional.pad(t, pad) for t in (q, k, v)), H,
        scale=hd ** -0.5)[..., :hd]
    want = flash_attention_plain(q, k, v, H)
    if S % BLOCK_Q == 0:
        assert torch.equal(padded, want)
    else:
        torch.testing.assert_close(padded, want, rtol=0,
                                   atol=1e-6 * v.abs().max().item())


def test_cpu_route_launches_nothing_and_has_no_backward():
    q, k, v = _t(*_qkv(1, 2, 1, 10, 10, 16, seed=4))
    before = dispatch.launch_counts()["flash_attention"]
    flash_attention_kernel(q, k, v, 2)
    assert dispatch.launch_counts()["flash_attention"] == before
    qg = q.reshape(1, 2, 10, 16).transpose(1, 2).clone().requires_grad_()
    kv = k.reshape(1, 1, 10, 16).transpose(1, 2)
    out = flash_attention(qg, kv, kv)
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


def test_wrapper_rejects_bad_heads_windows_and_devices():
    q, k, v = _t(*_qkv(1, 2, 1, 10, 10, 16, seed=5))
    with pytest.raises(ValueError, match="n_q_heads"):
        flash_attention_kernel(q, k, v, 3)
    with pytest.raises(ValueError, match="window"):
        flash_attention_kernel(q, k, v, 2, 0)
    with pytest.raises(ValueError, match="no route"):
        flash_attention_kernel(q.to("meta"), k.to("meta"), v.to("meta"), 2)
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_head_dim)
    assert [kernel_head_dim(h) for h in (1, 32, 33, 64, 65, 128)] == [
        32, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        kernel_head_dim(192)
