"""Carry weights and optimizer state over from the JAX package.

JAX parameters arrive as numpy arrays (``np.asarray`` of each leaf); the
flat θ follows ``ravel_pytree``'s leaf order (:mod:`repro_torch.core.tree`),
so a θ carried over here is the same policy in the port. A transformer's
nested parameter dict keeps the reference's layout (blocks stacked
``(L, ...)``), leaf for leaf.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.core.decbyzpg import Carry
from repro_torch.models.model import param_shapes
from repro_torch.optim.optimizers import AdamState


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def theta_from_jax_params(params: Sequence[Mapping[str, np.ndarray]],
                          device="cpu") -> torch.Tensor:
    """A JAX MLP's ``[{"w": (din, dout), "b": (dout,)}, ...]`` -> flat
    θ (d,) in ``ravel_pytree`` order (``[b0, w0, b1, w1, ...]``)."""
    return tree.ravel([{k: _tensor(v, device) for k, v in layer.items()}
                       for layer in params])


def carry_from_jax(theta, theta_prev, adam_state, device="cpu") -> Carry:
    """A JAX DecByzPG carry ``(θ (K, d), θ_prev (K, d), AdamState(step (K,),
    m (K, d), v (K, d)))`` -> the port's :class:`Carry`."""
    step, m, v = adam_state
    return Carry(_tensor(theta, device), _tensor(theta_prev, device),
                 AdamState(torch.tensor(np.asarray(step, dtype=np.int32),
                                        device=device),
                           _tensor(m, device), _tensor(v, device)))


def model_params_from_jax(params: Mapping, cfg: ModelConfig,
                          device="cpu") -> dict:
    """A JAX model's nested parameter dict (``repro.models.init_params``,
    leaves as numpy arrays, blocks stacked ``(L, ...)``) -> the port's
    parameters on ``device``. Raises if the tree or a shape differs from
    what ``cfg`` gives."""
    shapes = param_shapes(cfg)

    def conv(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, Mapping) or set(node) != set(want):
                got = sorted(node) if isinstance(node, Mapping) else node
                raise ValueError(f"params{path}: keys {got}, expected "
                                 f"{sorted(want)}")
            return {k: conv(node[k], want[k], f"{path}[{k!r}]")
                    for k in want}
        arr = np.asarray(node)
        if arr.shape != tuple(want):
            raise ValueError(f"params{path}: shape {arr.shape}, expected "
                             f"{tuple(want)}")
        return _tensor(arr, device)

    return conv(params, shapes, "")
