#!/usr/bin/env python3
"""Which parts of a policy-gradient step give an agent other bits in a
lane group of R·K agents than in a run of K, on one device.

    python3 tools/lane_bits.py [--device cuda] [--horizon 200]

Builds K = 13 MLP (16, 16) relu CartPole agents, rolls out M = 20
trajectories each, and compares, for the first K agents of the same
inputs repeated R = 2, 3 and 15 times: the policy's logits, the step
log-probabilities and each layer's weight and bias gradient of
``grad_estimate``. Then the library reductions a bias gradient could
take (``sum``, ``einsum``, ``bmm`` with a ones vector) and the port's
``column_tree_sum`` over (K, n, o) stacks. A line reads ``=`` when the
first K agents' result is bit-equal for every R, else the largest gap.
Without ``--device`` it runs on CUDA and raises where there is none.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--horizon", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    from repro_torch import resolve_device
    from repro_torch.core.noise import _gumbel
    from repro_torch.rl import gradient as G
    from repro_torch.rl.envs import make_env
    from repro_torch.rl.policy import MLPPolicy, column_tree_sum
    from repro_torch.rl.rollout import Trajectory, rollout

    dev = resolve_device(args.device)
    env = make_env(f"cartpole(horizon={args.horizon})")
    K, M, RS = 13, 20, (2, 3, 15)
    policy = MLPPolicy((env.obs_dim, 16, 16, env.n_actions), "relu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    theta = torch.randn((K, policy.d), generator=gen, device=dev) * 0.3
    traj = rollout(env, policy, theta, env.reset(gen, (K, M)),
                   _gumbel(gen, (K, M, env.horizon, env.n_actions)))
    w = torch.full((M,), 1.0 / M, device=dev)

    def rep(x, r):
        return torch.cat([x] * r)

    def report(name, fn, *xs):
        one = fn(*xs)
        gaps = [(one - fn(*(rep(x, r) for x in xs))[:K]).abs().max().item()
                for r in RS]
        shown = "=" if max(gaps) == 0 else f"gap {max(gaps):.3e}"
        print(f"[lane-bits] {dev} {name}: {shown}", flush=True)

    report("logits", lambda th, o: policy(th, o), theta, traj.obs)

    def grad(th, *t):
        return G.grad_estimate(policy, th, Trajectory(*t), 0.999, 0.0,
                               sample_weights=w)

    report("step_log_probs", lambda th, *t: G.step_log_probs(
        policy, th, Trajectory(*t)), theta, *traj)
    for i, layer in enumerate(policy.shapes):
        for k in ("w", "b"):
            report(f"grad_estimate layer {i} {k}",
                   lambda th, *t, i=i, k=k: policy.layers(grad(th, *t))[i][k],
                   theta, *traj)
    for n in (60, 400, 2000, 4000):
        for o in (2, 16, 64):
            g = torch.randn((K, n, o), generator=gen, device=dev)
            for name, fn in (
                    ("sum", lambda g: g.sum(1)),
                    ("einsum", lambda g: torch.einsum("anj->aj", g)),
                    ("bmm(ones, g)", lambda g: torch.bmm(
                        g.new_ones((g.shape[0], 1, g.shape[1])), g)[:, 0]),
                    ("column_tree_sum", column_tree_sum)):
                report(f"(K, {n}, {o}) {name}", fn, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
