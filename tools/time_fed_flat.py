#!/usr/bin/env python3
"""Phase 10's flat federated runs with phase 10c (a), timed, for one
checkout, on the GPU.

    python3 tools/time_fed_flat.py --root DIR --label NAME

Imports ``chip_smoke.py`` and ``src/`` from DIR (a checkout, or a copy of
the parent commit unpacked with ``git archive``), builds its kernels and
runs its ``phase_fed_flat`` (the three full-width flat runs, each
repeated with ``sharded=True`` and compared bit for bit), then prints
``[flat-time] NAME: ... s`` on the host clock. Run it for the parent and
for the change in one call to compare what phase 10c (a) costs. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_fed_flat: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke
    chip_smoke.phase_build()
    t0 = time.perf_counter()
    chip_smoke.phase_fed_flat(torch.device("cuda"))
    print(f"[flat-time] {chip_smoke.card()}: {args.label}: phase 10 flat "
          f"runs with 10c (a) {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
