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


@pytest.mark.parametrize("window", [1, 7, 32, 1000])
def test_plain_sliding_window_matches_pallas(window):
    H, S, hd = 2, 80, 16
    q, k, v = _qkv(1, H, H, S, S, hd, seed=1)
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
