"""RFA geometric median by smoothed Weiszfeld, in Gram (weight) space.

Every Weiszfeld iterate stays in the affine hull of the inputs, so with
``G = X Xᵀ`` the iteration runs on weights alone::

    z_t = w_tᵀ X,   ‖x_i − z_t‖² = G_ii − 2 (G w_t)_i + w_tᵀ G w_t

and the stack is read twice: once for ``G`` (the ``gram`` kernel) and once
for ``z = wᵀ X``. This is the algorithm of the JAX package's
``kernels/rfa/rfa.py::rfa_pallas``. Its two kernels are ported here:

* ``weiszfeld_weights``: (Bt, K, K) Gram matrices -> (Bt, K) weights after
  ``n_iter`` steps from w₀ = 1/K (``_weiszfeld_kernel``);
* ``weighted_sum``: (Bt, K, d) stack and (Bt, K) weights -> (Bt, d)
  (``_wsum_kernel``).

Each launches ``csrc/aggregation.cu`` on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor. Distances come from the Gram identity, so
tiny distances lose bits to cancellation; the smoothing floor ``nu``
bounds the effect, which is why the port keeps TF32 off.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_stack, register_kernel, \
    stream_of
from repro_torch.kernels.pairwise_dist.pairwise_dist import gram


def _check_iter(nu: float, n_iter: int) -> None:
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if not nu > 0:
        raise ValueError(f"nu must be > 0, got {nu}")


def weiszfeld_plain(g: torch.Tensor, nu: float = 1e-6,
                    n_iter: int = 32) -> torch.Tensor:
    """(Bt, K, K) -> (Bt, K) smoothed-Weiszfeld weights, in PyTorch."""
    _check_iter(nu, n_iter)
    k = g.shape[-1]
    diag = torch.diagonal(g, dim1=-2, dim2=-1)
    w = torch.full(g.shape[:-1], 1.0 / k, dtype=g.dtype, device=g.device)
    for _ in range(n_iter):
        gw = (g * w[..., None, :]).sum(-1)
        wgw = (w * gw).sum(-1, keepdim=True)
        d2 = torch.clamp_min(diag - 2.0 * gw + wgw, 0.0)
        iw = 1.0 / torch.sqrt(d2 + nu)
        w = iw / iw.sum(-1, keepdim=True)
    return w


_WEISZFELD = _build.CFunction("repro_weiszfeld_f32", "weiszfeld")
_WSUM = _build.CFunction("repro_wsum_f32", "wsum")


def _weiszfeld_cuda(g: torch.Tensor, nu: float = 1e-6,
                    n_iter: int = 32) -> torch.Tensor:
    _check_iter(nu, n_iter)
    bt, k, k2 = check_stack(g, "weiszfeld", _build.KMAX)
    if k2 != k:
        raise ValueError(f"weiszfeld: expected square Gram matrices, got "
                         f"shape {tuple(g.shape)}")
    w = torch.empty((bt, k), device=g.device, dtype=torch.float32)
    _WEISZFELD(g.data_ptr(), w.data_ptr(), bt, k, float(nu), int(n_iter),
               stream_of(g))
    return w


weiszfeld_weights = register_kernel("weiszfeld", plain=weiszfeld_plain,
                                    launch=_weiszfeld_cuda)


def weighted_sum_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(Bt, K, d), (Bt, K) -> (Bt, d): z = wᵀ X per batch element."""
    return (w[..., None] * x).sum(-2)


def _wsum_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    bt, k, d = check_stack(x, "wsum", _build.KMAX)
    if not (w.dtype == torch.float32 and w.shape == (bt, k)
            and w.is_contiguous() and w.device == x.device):
        raise ValueError(f"wsum: weights must be a contiguous float32 "
                         f"{(bt, k)} tensor on {x.device}, got "
                         f"{tuple(w.shape)} {w.dtype} on {w.device}")
    z = torch.empty((bt, d), device=x.device, dtype=torch.float32)
    _WSUM(x.data_ptr(), w.data_ptr(), z.data_ptr(), bt, k, d, stream_of(x))
    return z


weighted_sum = register_kernel("wsum", plain=weighted_sum_plain,
                               launch=_wsum_cuda)


def rfa(x: torch.Tensor, n_iter: int = 32, nu: float = 1e-6) -> torch.Tensor:
    """(Bt, K, d) -> (Bt, d) smoothed geometric medians: gram, then
    weiszfeld, then wsum."""
    w = weiszfeld_weights(gram(x), nu, n_iter)
    return weighted_sum(x, w)
