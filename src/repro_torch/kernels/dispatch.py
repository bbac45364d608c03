"""Kernel dispatch for the port: the tensor's device picks the route.

Every kernel is a :class:`Kernel` with two implementations of one
algorithm:

* a tensor on the CPU goes to the plain PyTorch version, which the CPU
  tests hold against the JAX package;
* a tensor on a CUDA device goes to the hand-written kernel, or the call
  raises.

There is no other route: no backend override, no environment variable and
no size cut-off. Each kernel counts its launches in ``launches``, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

_KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    """A named kernel routed by the device of its first tensor argument."""

    __slots__ = ("name", "plain", "_launch", "launches")

    def __init__(self, name: str, plain: Callable, launch: Callable):
        self.name = name
        self.plain = plain
        self._launch = launch
        self.launches = 0

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        if x.is_cuda:
            out = self._launch(x, *args, **kwargs)
            self.launches += 1
            return out
        if x.device.type == "cpu":
            return self.plain(x, *args, **kwargs)
        raise ValueError(f"kernel {self.name!r}: no route for a tensor on "
                         f"{x.device}")


def register_kernel(name: str, *, plain: Callable,
                    launch: Callable) -> Kernel:
    if name in _KERNELS:
        raise ValueError(f"kernel {name!r} is already registered")
    k = _KERNELS[name] = Kernel(name, plain, launch)
    return k


def kernels() -> Dict[str, Kernel]:
    """The registered kernels, by name."""
    return dict(_KERNELS)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in _KERNELS.items()}


def reset_launches() -> None:
    for k in _KERNELS.values():
        k.launches = 0


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, read
    without building a ``torch.cuda.Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_stack(x: torch.Tensor, name: str, kmax: int):
    """What the CUDA kernels take: a contiguous f32 (Bt, K, d) stack with
    1 <= K <= ``kmax`` and 1 <= Bt <= 65535. Returns ``(Bt, K, d)``; the
    common case passes one test, and only a refused tensor is diagnosed."""
    if x.dtype == torch.float32 and x.dim() == 3 and x.is_contiguous():
        bt, k, d = x.shape
        if 1 <= k <= kmax and 1 <= bt <= 65535 and d >= 1:
            return bt, k, d
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: expected a (Bt, K, d) stack, got shape "
                         f"{tuple(x.shape)}")
    bt, k, d = x.shape
    if not (1 <= k <= kmax and bt >= 1 and d >= 1):
        raise ValueError(f"{name}: needs 1 <= K <= {kmax}, Bt >= 1, d >= 1; "
                         f"got shape {tuple(x.shape)}")
    if bt > 65535:
        raise ValueError(f"{name}: batch {bt} exceeds the grid's 65535")
    raise ValueError(f"{name}: expected a contiguous tensor")
