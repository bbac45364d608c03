"""RFA geometric median by smoothed Weiszfeld, in Gram (weight) space.

Every Weiszfeld iterate stays in the affine hull of the inputs, so with
``G = X Xᵀ`` the iteration runs on weights alone::

    z_t = w_tᵀ X,   ‖x_i − z_t‖² = G_ii − 2 (G w_t)_i + w_tᵀ G w_t

and the stack is read twice: once for ``G`` (the ``gram`` kernel) and once
for ``z = wᵀ X``. This is the algorithm of the JAX package's
``kernels/rfa/rfa.py::rfa_pallas``. Its two kernels are ported here:

* ``weiszfeld_weights``: (Bt, K, K) Gram matrices -> (Bt, K) weights after
  ``n_iter`` steps from w₀ = 1/K (``_weiszfeld_kernel``), with one
  smoothing floor ``nu`` for the batch or one per batch element (the rows
  of a lane group sweeping ``rfa(nu=...)``);
* ``weighted_sum``: (Bt, K, d) stack and (Bt, K) weights -> (Bt, d)
  (``_wsum_kernel``).

Each launches ``csrc/aggregation.cu`` on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor. Distances come from the Gram identity, so
tiny distances lose bits to cancellation; the smoothing floor ``nu``
bounds the effect, which is why the port keeps TF32 off.

:func:`weiszfeld_plain` is the kernel's specification of order: the same
IEEE operations in the same order (every sum a halving tree, see
:func:`tree_sum`), so on equal inputs the two give the same bits.
:func:`weiszfeld_instance` is the kernel's plan: which compiled height a
launch takes.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_stack, register_kernel, \
    stream_of
from repro_torch.kernels.pairwise_dist.pairwise_dist import gram


#: the heights ``weiszfeld_kernel`` is compiled for, each taking any k up
#: to the height (read at run time): exact instances for CartPole's 7
#: bucket means and K = 13 ran within 1.4% of heights 8 and 16 on an H100
#: (PERF.md)
WEISZFELD_HEIGHTS = (8, 16, 32)


def weiszfeld_instance(k: int) -> int:
    """The height of the Weiszfeld kernel for a stack of ``k``: the
    smallest compiled height >= k."""
    for h in WEISZFELD_HEIGHTS:
        if 1 <= k <= h:
            return h
    raise ValueError(f"weiszfeld: no instance holds K={k} (1 <= K <= "
                     f"{WEISZFELD_HEIGHTS[-1]})")


def _check_iter(nu, n_iter: int) -> None:
    """``n_iter >= 0`` and every ``nu > 0``: a number, or one value per
    batch element (read to the host: on a card, one synchronization; the
    lane route passes a number whenever its rows share one)."""
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if not isinstance(nu, torch.Tensor):
        if not nu > 0:
            raise ValueError(f"nu must be > 0, got {nu}")
    elif not bool(torch.all(nu > 0)):
        raise ValueError(f"every nu must be > 0, got {nu.tolist()}")


@functools.lru_cache(maxsize=64)
def _filled(nu: float, bt: int, device: torch.device) -> torch.Tensor:
    """One number's (bt,) array, made once per (value, batch, device):
    the main path calls with the same few every step. Read-only."""
    return torch.full((bt,), nu, dtype=torch.float32, device=device)


def nu_rows(nu, bt: int, device) -> torch.Tensor:
    """``nu`` as the (bt,) float32 array the kernel reads, one value per
    batch element: a number filled in, or a (bt,) tensor rounded to
    float32."""
    if isinstance(nu, torch.Tensor):
        if nu.shape != (bt,):
            raise ValueError(f"weiszfeld: nu must be a number or a ({bt},) "
                             f"tensor, got shape {tuple(nu.shape)}")
        return nu.to(device=device, dtype=torch.float32).contiguous()
    return _filled(float(nu), bt, torch.device(device))


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order: the slots padded with
    -0.0 to a power of two P, then halved, slot i += slot i + h for h =
    P/2 .. 1 (``csrc/fixed_sums.cuh``). ``x + -0.0`` is ``x`` for every x,
    so any power of two >= the length gives the same bits."""
    n = v.shape[-1]
    p = 1 << (n - 1).bit_length()
    if p > n:
        v = F.pad(v, (0, p - n), value=-0.0)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an f32 tensor, as CUDA's
    ``__fsqrt_rn``: PyTorch's CPU ``sqrt`` of float32 misses by an ulp now
    and then; the float64 root rounded once to f32 never does (the f32
    root of a float is never that near a rounding midpoint)."""
    return torch.sqrt(x.double()).to(x.dtype)


def weiszfeld_plain(g: torch.Tensor, nu=1e-6,
                    n_iter: int = 32) -> torch.Tensor:
    """(Bt, K, K) -> (Bt, K) smoothed-Weiszfeld weights, in PyTorch, in
    the kernel's order: per step ``gw_j = tree_sum_l(g_jl w_l)``, ``wgw =
    tree_sum_j(w_j gw_j)``, ``d2 = max((diag - 2 gw) + wgw, 0)`` (NaN
    kept), ``iw = 1 / sqrt(d2 + nu)`` (``sqrt_rn``) and ``w = iw /
    tree_sum(iw)``. Every division is tensor by tensor (a Python number
    over a tensor goes through a reciprocal on CUDA) and ``nu`` is rounded
    to the tensor's type first, as the kernel takes it. ``nu`` is a
    number or a (Bt,) tensor, one value per batch element."""
    _check_iter(nu, n_iter)
    k = g.shape[-1]
    like = dict(dtype=g.dtype, device=g.device)
    one = torch.tensor(1.0, **like)
    nu_t = nu.to(**like)[:, None] if isinstance(nu, torch.Tensor) \
        else torch.tensor(nu, **like)
    diag = torch.diagonal(g, dim1=-2, dim2=-1)
    w = torch.full(g.shape[:-1], 1.0 / k, **like)
    for _ in range(n_iter):
        gw = tree_sum(g * w[..., None, :])
        wgw = tree_sum(w * gw)[..., None]
        d2 = torch.clamp_min(diag - 2.0 * gw + wgw, 0.0)
        iw = one / sqrt_rn(d2 + nu_t)
        w = iw / tree_sum(iw)[..., None]
    return w


_WEISZFELD = _build.CFunction("repro_weiszfeld_f32", "weiszfeld")
_WSUM = _build.CFunction("repro_wsum_f32", "wsum")


def _weiszfeld_cuda(g: torch.Tensor, nu=1e-6,
                    n_iter: int = 32) -> torch.Tensor:
    _check_iter(nu, n_iter)
    bt, k, k2 = check_stack(g, "weiszfeld", _build.KMAX)
    if k2 != k:
        raise ValueError(f"weiszfeld: expected square Gram matrices, got "
                         f"shape {tuple(g.shape)}")
    nus = nu_rows(nu, bt, g.device)
    w = torch.empty((bt, k), device=g.device, dtype=torch.float32)
    _WEISZFELD(g.data_ptr(), nus.data_ptr(), w.data_ptr(), bt, k,
               int(n_iter), weiszfeld_instance(k), stream_of(g))
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
