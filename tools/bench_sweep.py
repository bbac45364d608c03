#!/usr/bin/env python3
"""What a resumable sweep costs against the one-shot ``Experiment`` on
the GPU.

    python3 tools/bench_sweep.py [--windows 1,3,15] [--rounds 2]

Runs ``chip_smoke.py``'s ``fig5_byzpg`` cell (ByzPG, attack × aggregator,
4 scenarios × 3 seeds × T=15 on ``cartpole(horizon=100)``) as
``Experiment(...).run()`` and as ``SweepRunner(windows=W, out_dir=...)``
with a fresh sweep directory for each W, in turns (the Experiment, each
W up, each W down, the Experiment) ``--rounds`` times, after one warm
run. Both run under ``obs.telemetry`` with a memory sink, so both pay
for the same host instrumentation. Prints the card, every wall (host
clock around a synchronised run), the medians, each sweep's window
commits (``sweep.commit`` host spans: carry, chunk and state written)
and their sum, and checks every sweep's result bit for bit against the
Experiment's. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

CELL = dict(algo="byzpg", env="cartpole(horizon=100)", T=15,
            seeds=(0, 1, 2),
            axes={"attack": ("large_noise", "avg_zero"),
                  "aggregator": ("rfa", "mean")},
            K=13, n_byz=3, N=20, B=4, eta=2e-2)


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", default="1,3,15",
                    help="comma-separated window counts")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    windows = [int(w) for w in args.windows.split(",")]

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import Experiment, obs
    from repro_torch.sweep import SweepRunner

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    warm = dict(CELL, T=2, seeds=(0,))
    Experiment(device=dev, **warm).run()

    walls = {"experiment": []}
    walls.update({f"sweep W={w}": [] for w in windows})
    commits = {w: [] for w in windows}
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        order = ["experiment", *windows, *windows[::-1], "experiment"]
        for r in range(args.rounds):
            for i, who in enumerate(order):
                obs.get_tracer().clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with obs.telemetry(obs.MemorySink()):
                    if who == "experiment":
                        res = Experiment(device=dev, **CELL).run()
                    else:
                        out = os.path.join(tmp, f"r{r}_{i}_w{who}")
                        res = SweepRunner(windows=who, out_dir=out,
                                          device=dev, **CELL).run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                name = who if who == "experiment" else f"sweep W={who}"
                walls[name].append(secs)
                line = f"[run] round {r} {name}: {secs:.3f} s"
                if who != "experiment":
                    ms = [e["dur"] / 1e3 for e in obs.get_tracer().events
                          if e["name"] == "sweep.commit"]
                    commits[who].extend(ms)
                    line += (f"; {len(ms)} commits, sum {sum(ms):.3f} ms, "
                             f"median {_median(ms):.3f} ms, largest "
                             f"{max(ms):.3f} ms")
                print(line, flush=True)
                if ref is None:
                    ref = res
                    continue
                for scn in ref.keys():
                    a, b = ref[scn], res[tuple(scn)]
                    if not (np.array_equal(a["returns"], b["returns"])
                            and np.array_equal(a["vec"], b["vec"])):
                        raise AssertionError(f"{name}: {scn} differs from "
                                             f"the first run")
    print(f"[summary] {card}; fig5_byzpg, medians of {args.rounds * 2} "
          f"walls each, every result bit-equal to the first:")
    base = _median(walls["experiment"])
    for name, xs in walls.items():
        print(f"[summary] {name}: median {_median(xs):.3f} s "
              f"({_median(xs) / base - 1:+.1%} against the Experiment), "
              f"runs {[round(x, 3) for x in xs]}")
    for w, ms in commits.items():
        print(f"[summary] W={w}: {len(ms)} commits, median "
              f"{_median(ms):.3f} ms, largest {max(ms):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
