"""Paper Fig. 1 on the PyTorch/CUDA port: speed-up of DecByzPG with
federation size K (honest case).

One declarative Experiment over the K axis (K is static: one lane group
per K, its seeds stepped together as rows); K=1 recovers PAGE-PG. Runs on CUDA; ``--device cpu`` runs
the plain PyTorch versions.

  python examples_torch/federation_speedup.py [--iters 30] [--device cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch import Experiment, obs, resolve_device  # noqa: E402


def main(argv=None):
    """Run the example; returns its ``ExperimentResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    obs.progress(f"== DecByzPG speed-up in K (alpha=0, {args.seeds} seeds); "
                 f"K=1 is PAGE-PG ==")
    exp = Experiment(algo="decbyzpg", env="cartpole(horizon=200)",
                     T=args.iters, seeds=args.seeds,
                     axes={"K": (1, 5, 13)}, N=20, B=4, eta=2e-2,
                     override=lambda c: dataclasses.replace(
                         c, kappa=4 if c.K > 1 else 0),
                     device=dev)
    res = exp.run()
    curves = {scn.K: out for scn, out in res.items()}
    for K, out in curves.items():
        obs.progress(f"K={K:2d}: final return {out['final_return_mean']:6.1f}"
                     f"±{out['final_return_ci95']:.1f} after "
                     f"{out['samples'][:, -1].mean():.0f} samples/agent")
    # return achieved at a fixed per-agent sample budget
    budget = curves[13]["samples"].mean(axis=0)[-1]
    obs.progress(f"\nreturn at equal per-agent sample budget ({budget:.0f}):")
    for K, out in curves.items():
        samples = out["samples"].mean(axis=0)
        idx = min(int(np.searchsorted(samples, budget)),
                  out["returns_mean"].shape[0] - 1)
        r = out["returns_mean"][max(idx - 2, 0):idx + 1].mean()
        obs.progress(f"  K={K:2d}: {r:.1f}")
    return res


if __name__ == "__main__":
    main()
