#!/usr/bin/env python3
"""Repeatability of each side of ``chip_smoke.py``'s card-vs-CPU check of
the federated trainers (``phase_fed_cpu_agreement``), on the GPU.

    python3 tools/fed_cpu_repeat.py [--runs N]

Runs that check's one side (``fed_two_steps``: the reduced Llama, K = 4,
2 steps, tree and flat trainers) N times on the CPU with PyTorch's
default thread count, N times on one CPU thread and N times on the card.
For each side it prints how many bit-distinct θ the N runs gave and the
largest gap between two of them as a share of max|θ|, then the gap of
every CPU run to the card's first run, as the check measures it. A side
that moves between runs is a source of the check's spread; one that
never moves is not. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("fed_cpu_repeat: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke
    chip_smoke.phase_build()
    threads = torch.get_num_threads()
    print(f"[repeat] {chip_smoke.card()}: {args.runs} runs a side, CPU "
          f"threads {threads}", flush=True)

    def runs(dev, n_threads):
        torch.set_num_threads(n_threads)
        try:
            return [chip_smoke.fed_two_steps(dev, flat)[0]
                    for _ in range(args.runs)]
        finally:
            torch.set_num_threads(threads)

    for flat in (False, True):
        label = "flat" if flat else "tree"
        sides = {"cpu, default threads": runs("cpu", threads),
                 "cpu, one thread": runs("cpu", 1),
                 "card": runs(torch.device("cuda"), threads)}
        for side, thetas in sides.items():
            gaps = [chip_smoke.tree_gap(thetas[0], t) for t in thetas]
            distinct = 1 + sum(
                all(chip_smoke.tree_gap(thetas[j], thetas[i])[0] > 0
                    for j in range(i)) for i in range(1, len(thetas)))
            print(f"[repeat] {label}, {side}: {distinct} distinct of "
                  f"{len(thetas)}, largest gap to run 0 "
                  f"{max(e / s for e, s in gaps):.3e} of max|theta|",
                  flush=True)
        card0 = sides["card"][0]
        for side in ("cpu, default threads", "cpu, one thread"):
            shares = [e / s for e, s in (chip_smoke.tree_gap(t, card0)
                                         for t in sides[side])]
            print(f"[repeat] {label}, {side} vs card run 0: "
                  + " ".join(f"{x:.3e}" for x in shares), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
