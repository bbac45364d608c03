#!/usr/bin/env python3
"""The transformer policy's no-grad passes on the chunked route, as the
port runs them, against the flash kernel, on the GPU.

    python3 tools/bench_tf_route.py [--iters N] [--rounds R]

Runs the first configuration of ``chip_smoke.transformer_runs()``
(DecByzPG with bucketing ∘ RFA and MDA, K=13, N=20, B=4, the default
transformer policy, ``cartpole(horizon=50)``) as the port runs it, every
policy pass on ``attention="chunked"``, and with the passes that autograd
does not record (the rollouts and the importance weights) moved onto the
flash kernel, in turns (flash, chunked, chunked, flash) for R rounds of N
iterations each. The gradient estimate takes the chunked route in both.
Prints the card's name and power limit, then for each route the median ms
per iteration of the whole step and of each range (``chip_smoke._Ranges``:
the host clock, synchronised at both ends of each range), the spread of
the runs, and the largest |θ| difference between the routes' final θ.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_tf_route: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core.decbyzpg import run_decbyzpg
    from repro_torch.kernels import dispatch
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.transformer_policy import TransformerPolicy

    print(cs.card())
    label, _, _, cfg, _ = cs.transformer_runs()[0]
    env = make_cartpole(horizon=50)
    chunked_forward = TransformerPolicy.forward

    def flash_forward(self, theta, obs):
        recorded = torch.is_grad_enabled() and theta.requires_grad
        return torch.stack([self.logits(self.layers(theta[k]), obs[k],
                                        "chunked" if recorded else "flash")
                            for k in range(theta.shape[0])])

    def use(route):
        TransformerPolicy.forward = (flash_forward if route == "flash"
                                     else chunked_forward)

    def timed(route):
        use(route)
        dispatch.reset_launches()
        try:
            torch.cuda.synchronize()
            with cs._Ranges() as ranges:
                t0 = time.perf_counter()
                out = run_decbyzpg(env, cfg, args.iters)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / args.iters
        finally:
            use("chunked")
        per = {k: v / args.iters for k, v in ranges.ms.items()}
        flash = dispatch.launch_counts()["flash_attention"] // args.iters
        return wall, per, flash, out["theta"]

    for route in ("flash", "chunked"):                 # warm both routes
        use(route)
        run_decbyzpg(env, cfg, 1)
    use("chunked")
    walls = {"flash": [], "chunked": []}
    ranges = {"flash": [], "chunked": []}
    theta = {}
    for _ in range(args.rounds):
        for route in ("flash", "chunked", "chunked", "flash"):
            wall, per, flash, theta[route] = timed(route)
            walls[route].append(wall)
            ranges[route].append(per)
            print(f"[route] {label} {route}: {wall:.3f} ms/iter, ranges "
                  f"ms/iter { {k: round(v, 3) for k, v in per.items()} }, "
                  f"flash launches/iter {flash}", flush=True)
    for route in ("flash", "chunked"):
        keys = sorted(ranges[route][0])
        med = {k: cs._median([r[k] for r in ranges[route]]) for k in keys}
        print(f"[route] {route}: median {cs._median(walls[route]):.3f} "
              f"ms/iter over {len(walls[route])} runs of {args.iters} "
              f"(min {min(walls[route]):.3f}, max {max(walls[route]):.3f}); "
              f"median ranges ms/iter "
              f"{ {k: round(v, 3) for k, v in med.items()} }")
    diff = (theta["flash"] - theta["chunked"]).abs().max().item()
    print(f"[route] final θ, flash vs chunked route: max abs diff {diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
