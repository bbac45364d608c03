"""The port's flash attention on the CPU: its plain version (the CUDA
kernel's algorithm in PyTorch) against the JAX package's Pallas body in
interpret mode and its oracle, the model-layout wrapper against the
reference's, and the op's boundaries. The CUDA kernel itself is held
against the plain version on a GPU by ``tests/test_torch_cuda.py``."""
import importlib

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
    BLOCK_Q, KERNEL_INSTANCES, kernel_head_dim, kernel_instance)

# the kernel's module (the package's ``flash_attention`` is the op)
fa = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

torch.set_num_threads(2)

#: the reference's own tolerance for its f32 flash kernel tests
TOL = 2e-5


def _qkv(B, H, Hkv, Sq, Sk, hd, seed=0, hd_v=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B * H, Sq, hd), (B * Hkv, Sk, hd),
                      (B * Hkv, Sk, hd if hd_v is None else hd_v))]


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


@pytest.mark.parametrize("hd", [8, 48, 50, 96, 160, 200])
@pytest.mark.parametrize("S", [128, 130])
def test_plain_on_zero_padded_head_dims_gives_the_same_result(hd, S):
    """What the CUDA route does at a head dim it was not compiled for: q,
    k and v zero-padded to the next compiled head dim, the true
    ``hd**-0.5`` passed in, the output sliced back. Zero columns add
    nothing to q·k and give only output columns that are sliced away, so
    the two differ only in how the host BLAS sums each q·k and p·v: a
    padded product may take another kernel and another summation order
    than the unpadded one, at any S (MKL on an AMD EPYC host did at hd 8
    and S 128). Each output row is a convex combination of v's rows, so
    reordering its f32 sums moves it by a few ulps of max|v|, and the
    scores' reordering moves p by a few ulps relative: the bound is
    1e-6·max|v| (about 8 ulps of max|v|), the ragged tile's. The CUDA
    kernel's own bits under padding are held on the card
    (``chip_smoke.py`` ``phase_flash_padded``)."""
    H, Hkv, B = 4, 2, 1
    q, k, v = _t(*_qkv(B, H, Hkv, S, S, hd, seed=hd))
    hd_k = kernel_head_dim(hd)
    assert hd_k == {8: 32, 48: 64, 50: 64, 96: 128, 160: 192,
                    200: 256}[hd]
    pad = (0, hd_k - hd)
    padded = flash_attention_plain(
        *(torch.nn.functional.pad(t, pad) for t in (q, k, v)), H,
        scale=hd ** -0.5)[..., :hd]
    want = flash_attention_plain(q, k, v, H)
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
    assert [kernel_head_dim(h) for h in (1, 32, 33, 64, 65, 128)] == [
        32, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="Queue 2"):
        kernel_head_dim(257)


# --- head dims 129-256 and a v head dim of its own ----------------------

def test_kernel_head_dim_maps_129_to_256_and_raises_above():
    """129-192 run on the hd-192 instance, 193-256 on the hd-256 one;
    above 256 there is no tiling (ROADMAP, Queue 2)."""
    assert {kernel_head_dim(h) for h in range(129, 193)} == {192}
    assert {kernel_head_dim(h) for h in range(193, 257)} == {256}
    for hd in (257, 320, 512):
        with pytest.raises(ValueError, match="up to 256.*Queue 2"):
            kernel_head_dim(hd)


@pytest.mark.parametrize("hd,hd_v,want", [
    (192, 128, (192, 128)),         # DeepSeek-V2-Lite's MLA
    (96, 64, (128, 64)),            # MiniCPM3-4B's
    (160, 128, (192, 128)), (160, 100, (192, 128)), (192, 160, (192, 192)),
    (200, 200, (256, 256)), (200, 64, (256, 256)), (256, 256, (256, 256)),
    (64, 128, (128, 128)),          # a wider v pads q and k up to it
    (32, 16, (32, 32)), (128, 128, (128, 128)),
])
def test_kernel_instance_is_the_smallest_that_holds_both(hd, hd_v, want):
    assert kernel_instance(hd, hd_v) == want
    assert want in KERNEL_INSTANCES


# f32; G = 1, 2, 4 and 5, ragged S, windows; the Pallas body and the oracle
# pad nothing of their own beyond the head dim (hp = 256 at all three)
@pytest.mark.parametrize("B,H,Hkv,S,hd,window", [
    (1, 4, 2, 100, 160, None),      # G = 2, ragged
    (2, 2, 2, 70, 192, None),       # batched
    (1, 4, 1, 77, 192, 20),         # G = 4, window across 32-key tiles
    (1, 5, 1, 90, 256, None),       # G = 5
    (1, 2, 1, 66, 256, 33),         # window
])
def test_plain_wide_head_dims_match_pallas_and_oracle(B, H, Hkv, S, hd,
                                                      window):
    """The plain version at hd 160, 192 and 256 (32-key KV tiles, as the
    kernel's wide instances walk them) against the Pallas body in
    interpret mode and the oracle, within the reference's own f32
    tolerance (2e-5)."""
    q, k, v = _qkv(B, H, Hkv, S, S, hd, seed=hd + S)
    got = flash_attention_plain(*_t(q, k, v), H, window).numpy()
    assert got.shape == (B * H, S, hd)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), n_q_heads=H,
                                    window=window, block_q=32, block_k=32,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)
    oracle = fa_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              n_q_heads=H, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL)


@pytest.mark.parametrize("hd,hd_v,H,Hkv,S,window", [
    (192, 128, 4, 4, 80, None),     # DeepSeek-V2-Lite's MLA (G = 1)
    (192, 128, 4, 2, 97, 40),       # ... with GQA and a window
    (96, 64, 4, 4, 70, None),       # MiniCPM3-4B's
    (256, 64, 2, 1, 45, None),
])
def test_plain_with_a_narrower_v_matches_the_padded_reference(
        hd, hd_v, H, Hkv, S, window):
    """v of its own head dim against the reference, which takes one head
    dim: v zero-padded to q's, the result sliced to v's (zero columns of
    v give only the columns sliced away), 2e-5."""
    B = 2
    q, k, v = _qkv(B, H, Hkv, S, S, hd, seed=hd_v + S, hd_v=hd_v)
    got = flash_attention_plain(*_t(q, k, v), H, window).numpy()
    assert got.shape == (B * H, S, hd_v)
    vp = np.pad(v, ((0, 0), (0, 0), (0, hd - hd_v)))
    oracle = fa_ref.attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(vp), n_q_heads=H, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle)[..., :hd_v],
                               atol=TOL)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(vp), n_q_heads=H,
                                    window=window, block_q=32, block_k=32,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas)[..., :hd_v],
                               atol=TOL)
    # the model layout: the reference's wrapper on the padded v, sliced
    q4, k4, v4 = (x.reshape(B, -1, S, x.shape[-1]).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    layout = flash_attention(*_t(q4.copy(), k4.copy(), v4.copy()), window)
    assert layout.shape == (B, S, H, hd_v)
    want = jax_ops.flash_attention(
        jnp.asarray(q4), jnp.asarray(k4),
        jnp.asarray(np.pad(v4, ((0, 0),) * 3 + ((0, hd - hd_v),))),
        window=window, use_pallas=False)
    np.testing.assert_allclose(layout.numpy(), np.asarray(want)[..., :hd_v],
                               atol=TOL)


@pytest.mark.parametrize("hd,hd_v,layout", [
    (160, 160, False), (192, 128, True), (96, 64, True), (200, 200, False),
    (130, 100, True), (48, 48, True),
])
def test_cuda_route_pads_to_a_compiled_instance(monkeypatch, hd, hd_v,
                                                layout):
    """What the CUDA route hands its launch, with the launch replaced by
    the plain version on the tensors it is given: a compiled (q/k, v)
    instance, the true scale, and, once sliced, the plain version's
    result at the true head dims (the padding bound of
    :func:`test_plain_on_zero_padded_head_dims_gives_the_same_result`,
    1e-6·max|v|)."""
    seen = []

    def launch(q, k, v, n_q_heads, window, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        if n_q_heads is not None:
            return flash_attention_plain(q, k, v, n_q_heads, window, scale)
        B, S, H, _ = q.shape
        out = flash_attention_plain(*(fa._fold(x) for x in (q, k, v)), H,
                                    window, scale)
        return fa._unfold(out, B).contiguous()

    monkeypatch.setattr(fa, "_flash_launch", launch)
    B, H, Hkv, S, window = 1, 4, 2, 75, 30
    q, k, v = _t(*_qkv(B, H, Hkv, S, S, hd, seed=3, hd_v=hd_v))
    if layout:
        q, k, v = (x.reshape(B, -1, S, x.shape[-1]).transpose(1, 2)
                   for x in (q, k, v))
        got = fa._flash_cuda(q, k, v, None, window)
        want = fa._plain(q, k, v, None, window)
    else:
        got = fa._flash_cuda(q, k, v, H, window)
        want = flash_attention_plain(q, k, v, H, window)
    top, top_v = kernel_instance(hd, hd_v)
    assert seen == [(top, top, top_v, hd ** -0.5)]
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * v.abs().max().item())


def test_k_and_v_must_agree_but_in_the_head_dim():
    q, k, v = _t(*_qkv(1, 2, 1, 10, 10, 32, seed=5, hd_v=16))
    assert flash_attention_plain(q, k, v, 2).shape == (2, 10, 16)
    with pytest.raises(ValueError, match="every axis but the last"):
        flash_attention_plain(q, k, v[:, :9], 2)
    with pytest.raises(ValueError, match="every axis but the last"):
        fa._flash_cuda(q, k, v[:, :9], 2)
    with pytest.raises(ValueError, match="head_dim for q and k"):
        fa._flash_cuda(q, k[..., :16], v, 2)
