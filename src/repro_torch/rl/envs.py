"""Episodic environments as batched tensor code (fixed horizon, absorbing
termination): the port of the JAX package's ``rl/envs.py``.

A state is a tensor (..., obs_dim) with any leading batch dims (the port
steps (K, M) environments at once); the observation is the state itself.
``reset`` draws from an explicit :class:`torch.Generator`. The dynamics
repeat the reference's float32 operations in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.registry import Spec, register, resolve


@dataclasses.dataclass(frozen=True)
class Env:
    name: str
    obs_dim: int
    n_actions: int
    horizon: int
    reset: Callable   # (generator, batch_shape) -> state (*batch, obs_dim)
    step: Callable    # (state, action) -> (state, reward, done)


def _uniform(generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


# ---------------------------------------------------------------------------
# CartPole (Barto-Sutton-Anderson dynamics)
# ---------------------------------------------------------------------------

def make_cartpole(horizon: int = 200) -> Env:
    g, mc, mp, lp, f, dt = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    mt = mc + mp
    pml = mp * lp
    th_max = 12 * math.pi / 180

    def reset(generator, batch_shape):
        return _uniform(generator, (*batch_shape, 4), -0.05, 0.05)

    def step(s, a):
        x, xd, th, thd = s.unbind(-1)
        force = torch.where(a == 1, f, -f)
        ct, st = torch.cos(th), torch.sin(th)
        tmp = (force + pml * (thd * thd) * st) / mt
        thdd = (g * st - ct * tmp) / (lp * (4.0 / 3.0 - mp * (ct * ct) / mt))
        xdd = tmp - pml * thdd * ct / mt
        s2 = torch.stack([x + dt * xd, xd + dt * xdd,
                          th + dt * thd, thd + dt * thdd], dim=-1)
        done = (s2[..., 0].abs() > 2.4) | (s2[..., 2].abs() > th_max)
        return s2, torch.ones_like(x), done

    return Env("cartpole", 4, 2, horizon, reset, step)


# ---------------------------------------------------------------------------
# LunarLander-lite
# ---------------------------------------------------------------------------

def make_lunarlander(horizon: int = 300) -> Env:
    g, dt = -1.6, 0.05
    main_t, side_t = 6.0, 0.6

    def reset(generator, batch_shape):
        # state: x, y, vx, vy, theta, omega
        xv = _uniform(generator, (*batch_shape, 2), -0.3, 0.3)
        s = torch.zeros((*batch_shape, 6), device=xv.device)
        s[..., 0] = xv[..., 0]
        s[..., 1] = 1.4
        s[..., 2] = xv[..., 1]
        return s

    def potential(x, y, vx, vy, th):
        return (-10.0 * torch.sqrt(x * x + y * y)
                - 10.0 * torch.sqrt(vx * vx + vy * vy)
                - 10.0 * th.abs())

    def step(s, a):
        x, y, vx, vy, th, om = s.unbind(-1)
        main = (a == 2).float()
        left = (a == 1).float()
        right = (a == 3).float()
        fx = main * main_t * (-torch.sin(th))
        fy = main * main_t * torch.cos(th) + g
        torque = (left - right) * side_t
        vx2, vy2 = vx + dt * fx, vy + dt * fy
        x2, y2 = x + dt * vx2, y + dt * vy2
        om2 = om + dt * torque
        th2 = th + dt * om2
        s2 = torch.stack([x2, y2, vx2, vy2, th2, om2], dim=-1)
        landed_zone = (x2.abs() < 0.25) & (vx2.abs() < 0.6) & \
            (vy2.abs() < 0.6) & (th2.abs() < 0.3)
        touch = y2 <= 0.0
        out = x2.abs() > 1.5
        done = touch | out
        shaped = potential(x2, y2, vx2, vy2, th2) \
            - potential(x, y, vx, vy, th)
        fuel = -0.3 * main - 0.03 * (left + right)
        zero = torch.zeros_like(x2)
        terminal = torch.where(touch & landed_zone, zero + 100.0,
                               torch.where(touch | out, zero - 100.0, zero))
        r = shaped + fuel + terminal
        return s2, r, done

    return Env("lunarlander", 6, 4, horizon, reset, step)


register("env", "cartpole")(make_cartpole)
register("env", "lunarlander")(make_lunarlander)


def make_env(name, **kw) -> Env:
    """Build an env from a spec (``"cartpole"``, ``"cartpole(horizon=100)"``,
    or a Spec); extra ``kw`` merge into the spec's kwargs. An ``Env`` is
    returned as it is."""
    if isinstance(name, Env):
        if kw:
            raise TypeError(f"cannot apply overrides {sorted(kw)} to an "
                            f"already-built Env ({name.name}); pass a "
                            f"spec instead")
        return name
    spec = Spec.of(name)
    if kw:
        spec = spec.with_kwargs(**kw)
    return resolve("env", spec)
