"""Carry weights and optimizer state over from the JAX package.

JAX parameters arrive as numpy arrays (``np.asarray`` of each leaf); the
flat θ follows ``ravel_pytree``'s leaf order (:mod:`repro_torch.core.tree`),
so a θ carried over here is the same policy in the port. A transformer's
nested parameter dict keeps the reference's layout (blocks stacked
``(L, ...)``), leaf for leaf: MLA's projections, and the MoE router
(float32), experts ``w_gate``/``w_up`` (L, E, d, f) and ``w_down`` (L,
E, f, d) and shared SwiGLU included; Hymba's Mamba subtree ``ssm``
(``A_log`` and ``D`` float32), and xLSTM's pairs stacked (L /
slstm_every, ...): the mLSTM ``m``, the sLSTM ``s``, ``norm_m`` and
``norm_s``. A federated trainer's state (``FedState`` /
``FlatFedState``) carries over mid-run, leaf by leaf.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.core.decbyzpg import Carry
from repro_torch.distributed.fed_trainer import (FedState, FlatFedState,
                                                place_fed_state,
                                                place_flat_fed_state)
from repro_torch.models.model import param_shapes
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import AdamState


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def theta_from_jax_params(params: Sequence[Mapping[str, np.ndarray]],
                          device=None) -> torch.Tensor:
    """A JAX MLP's ``[{"w": (din, dout), "b": (dout,)}, ...]`` -> flat
    θ (d,) in ``ravel_pytree`` order (``[b0, w0, b1, w1, ...]``), on
    ``resolve_device(device)``: CUDA unless the caller asks for the CPU."""
    device = resolve_device(device)
    return tree.ravel_tree([{k: _tensor(v, device) for k, v in layer.items()}
                            for layer in params])


def theta_from_jax_tree(params: Mapping, device=None) -> torch.Tensor:
    """A JAX transformer's nested parameter dict (leaves as numpy arrays)
    -> the port's flat θ (d,) in ``ravel_pytree`` order (keys sorted at
    every level), on ``resolve_device(device)``: the θ of the
    ``transformer`` policy (:mod:`repro_torch.rl.transformer_policy`)."""
    device = resolve_device(device)
    return tree.ravel_tree(tree.tree_map(lambda x: _tensor(x, device),
                                         params))


def carry_from_jax(theta, theta_prev, adam_state, device=None) -> Carry:
    """A JAX DecByzPG carry ``(θ (K, d), θ_prev (K, d), AdamState(step (K,),
    m (K, d), v (K, d)))`` -> the port's :class:`Carry` on
    ``resolve_device(device)``."""
    device = resolve_device(device)
    step, m, v = adam_state
    return Carry(_tensor(theta, device), _tensor(theta_prev, device),
                 AdamState(torch.tensor(np.asarray(step, dtype=np.int32),
                                        device=device),
                           _tensor(m, device), _tensor(v, device)))


def model_params_from_jax(params: Mapping, cfg: ModelConfig,
                          device=None) -> dict:
    """A JAX model's nested parameter dict (``repro.models.init_params``,
    leaves as numpy arrays, blocks stacked ``(L, ...)``) -> the port's
    parameters on ``resolve_device(device)``. Raises if the tree or a shape
    differs from what ``cfg`` gives."""
    device = resolve_device(device)
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


def fed_state_from_jax(state, device=None, mesh=None, cfg=None):
    """A JAX ``FedState`` or ``FlatFedState`` (any array leaves: numpy or
    jax) -> the port's, on ``resolve_device(device)``: every leaf with its
    dtype (f32 stacks, the int32 counters), the optimizer state as the
    port's class of the same name (``AdamState``, ``MomentumState``).
    Mid-run states carry over whole: ``prev ≠ params``, ``v ≠ 0``, Adam's
    step > 0. With a ``mesh`` the state is placed on it: a flat state by
    ``fed_trainer.place_flat_fed_state`` (each rank keeps its columns of
    every (K, D) stack), a tree state by ``fed_trainer.place_fed_state``
    with the leaf rules of ``cfg`` (required there)."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.array(x)).to(device)

    opt = state.opt_state
    opt_t = getattr(optimizers, type(opt).__name__)(
        *(tree.tree_map(conv, f) for f in opt))
    if hasattr(state, "theta"):
        return place_flat_fed_state(
            FlatFedState(conv(state.theta), conv(state.prev), conv(state.v),
                         opt_t, conv(state.step)), mesh)
    if mesh is not None and cfg is None:
        raise ValueError("fed_state_from_jax: a tree state placed on a mesh "
                         "needs its model config (the leaf rules)")
    params, prev, v = (tree.tree_map(conv, t) for t in
                       (state.params, state.prev_params, state.v))
    return place_fed_state(FedState(params, prev, v, opt_t,
                                    conv(state.step)), mesh, cfg)
