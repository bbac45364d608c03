"""Resilience across attack strengths (paper Fig. 3 analogue) on the
PyTorch/CUDA port.

DecByzPG vs the naive Dec-PAGE-PG baseline over a ladder of LargeNoise
sigmas: one declarative Experiment over attack × aggregator. The port
has no compiled lane programs: its scenarios, and each scenario's seeds,
run one after another. Runs on CUDA; ``--device cpu`` runs the plain
PyTorch versions.

  python examples_torch/attack_strength_sweep.py \
      [--iters 40] [--seeds 3] [--sigmas 1,10,50,100,200] [--device cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import Experiment, obs, resolve_device  # noqa: E402


def main(argv=None):
    """Run the example; returns its ``ExperimentResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--sigmas", default="1,10,50,100,200")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sigmas = tuple(float(s) for s in args.sigmas.split(","))

    exp = Experiment(
        algo="decbyzpg", env="cartpole(horizon=200)", T=args.iters,
        seeds=args.seeds,
        axes={"attack": tuple(f"large_noise(sigma={s})" for s in sigmas),
              "aggregator": ("rfa", "mean")},
        K=13, n_byz=3, N=20, B=4, eta=2e-2,
        override=lambda c: dataclasses.replace(
            c, kappa=0 if c.aggregator.name == "mean" else 5),
        device=dev)
    res = exp.run()

    obs.progress(f"== LargeNoise strength sweep, 3/13 Byzantine, "
                 f"{args.seeds} seeds; {len(res)} scenarios, run one "
                 f"after another ==")
    obs.progress(f"{'sigma':>8s} {'DecByzPG (rfa)':>18s} "
                 f"{'Dec-PAGE-PG (mean)':>20s}")
    for s in sigmas:
        robust = res.sel(attack=f"large_noise(sigma={s})",
                         aggregator="rfa")
        naive = res.sel(attack=f"large_noise(sigma={s})",
                        aggregator="mean")
        obs.progress(f"{s:8.0f} "
                     f"{robust['final_return_mean']:9.1f}"
                     f"±{robust['final_return_ci95']:<7.1f} "
                     f"{naive['final_return_mean']:11.1f}"
                     f"±{naive['final_return_ci95']:<7.1f}")
    obs.progress("\nDecByzPG holds its return as sigma grows; the naive mean "
                 "baseline degrades (the paper's Fig. 3 phenomenon).")
    return res


if __name__ == "__main__":
    main()
