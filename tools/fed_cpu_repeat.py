#!/usr/bin/env python3
"""Repeatability of each side of ``chip_smoke.py``'s card-vs-CPU check of
the federated trainers (``phase_fed_cpu_agreement``), on the GPU.

    python3 tools/fed_cpu_repeat.py [--runs N] [--deterministic]

Runs that check's one side (``fed_two_steps``: the reduced Llama, K = 4,
2 steps, tree and flat trainers) N times on the CPU with PyTorch's
default thread count, N times on one CPU thread and N times on the card.
For each side it prints how many bit-distinct θ the N runs gave and the
largest gap between two of them as a share of max|θ|, then the gap of
every CPU run to the card's first run, as the check measures it. A side
that moves between runs is a source of the check's spread; one that
never moves is not. ``--deterministic`` first sets
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and turns on
``torch.use_deterministic_algorithms(True)``, for this tool's process
only: an op with no deterministic form then raises, and the tool prints
the side, the trainer and the error (which names the op) and goes on
with the next side. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True) and "
                         "CUBLAS_WORKSPACE_CONFIG=:4096:8")
    args = ap.parse_args(argv)
    if args.deterministic:
        # read by cuBLAS when its first handle is made: before any CUDA use
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

    import torch
    if not torch.cuda.is_available():
        print("fed_cpu_repeat: no CUDA device", file=sys.stderr)
        return 2
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke
    chip_smoke.phase_build()
    threads = torch.get_num_threads()
    print(f"[repeat] {chip_smoke.card()}: {args.runs} runs a side, CPU "
          f"threads {threads}, deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()}", flush=True)

    def runs(dev, n_threads, label, side):
        torch.set_num_threads(n_threads)
        try:
            return [chip_smoke.fed_two_steps(dev, flat)[0]
                    for _ in range(args.runs)]
        except RuntimeError as e:
            if not args.deterministic:
                raise
            print(f"[repeat] {label}, {side}: raised under deterministic "
                  f"algorithms: {str(e).splitlines()[0]}", flush=True)
            return None
        finally:
            torch.set_num_threads(threads)

    for flat in (False, True):
        label = "flat" if flat else "tree"
        sides = {"cpu, default threads": (torch.device("cpu"), threads),
                 "cpu, one thread": (torch.device("cpu"), 1),
                 "card": (torch.device("cuda"), threads)}
        sides = {side: runs(dev, n, label, side)
                 for side, (dev, n) in sides.items()}
        sides = {side: t for side, t in sides.items() if t is not None}
        for side, thetas in sides.items():
            gaps = [chip_smoke.tree_gap(thetas[0], t) for t in thetas]
            distinct = 1 + sum(
                all(chip_smoke.tree_gap(thetas[j], thetas[i])[0] > 0
                    for j in range(i)) for i in range(1, len(thetas)))
            print(f"[repeat] {label}, {side}: {distinct} distinct of "
                  f"{len(thetas)}, largest gap to run 0 "
                  f"{max(e / s for e, s in gaps):.3e} of max|theta|",
                  flush=True)
        if "card" not in sides:
            continue
        card0 = sides["card"][0]
        for side in sorted(set(sides) - {"card"}):
            shares = [e / s for e, s in (chip_smoke.tree_gap(t, card0)
                                         for t in sides[side])]
            print(f"[repeat] {label}, {side} vs card run 0: "
                  + " ".join(f"{x:.3e}" for x in shares), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
