#!/usr/bin/env python3
"""Times ``gram`` and ``wsum`` of one source tree of the port on the GPU.

    python3 tools/bench_gram_wsum.py [--src DIR] [--label NAME] [--sweep-k]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees, e.g. a parent commit unpacked by ``git archive`` and the
working tree, can be measured in one call in turns (parent, change,
change, parent). For each input: the host's cost of one call (host clock
around a loop of calls, before the device is waited for), the issue-bound
time (``chip_smoke.time_ms``), the device time (a CUDA graph of the calls,
``chip_smoke.GraphTimer``) and the same three for ``torch.bmm`` on the same
inputs, with medians over ``chip_smoke.ROUNDS`` rounds. Inputs: the main
path's four shapes and the three large stacks of ``chip_smoke.py``.
``--sweep-k`` times only ``gram``'s device time and bound share at stacks
of about 872 MB (one 13-agent stack of 2^24 coordinates) for K from 4 to
32. Prints the card, one line per input and one JSON object last. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_K = (4, 7, 8, 12, 13, 14, 16, 17, 20, 24, 25, 28, 32)


def host_us(fn, reps: int) -> float:
    """Host µs per call of a loop of ``reps`` calls, before the device is
    waited for."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep-k", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_gram_wsum: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.pairwise_dist import gram
    from repro_torch.kernels.rfa import weighted_sum
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[bench] {args.label}: {card}; repro_torch from "
          f"{sys.modules['repro_torch'].__file__}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    if args.sweep_k:
        for k in SWEEP_K:
            d = (13 << 24) // k // 8192 * 8192
            x = torch.randn((1, k, d), generator=gen, device=dev)
            timer = cs.GraphTimer(lambda: gram(x), 5)
            ms = cs._median([timer.ms() for _ in range(cs.ROUNDS)])
            b = cs.bound(4 * (k * d + k * k), 2 * k * k * d)[0]
            rows.append(dict(name="gram", shape=[1, k, d], label=args.label,
                             device_ms=ms, bound_ms=b))
            print(f"[bench] {args.label} gram (1, {k}, {d}): device "
                  f"{ms:.6f} ms, bound {b:.6f} ms, {b / ms:.1%} of the "
                  f"bound", flush=True)
            del x, timer
            torch.cuda.empty_cache()
    for shape in [] if args.sweep_k else cs.MAIN_SHAPES + cs.LARGE_SHAPES:
        bt, k, d = shape
        large = shape in cs.LARGE_SHAPES
        reps = 3 if large else 200
        x = torch.randn(shape, generator=gen, device=dev) + 1.5
        xt = x.transpose(1, 2)
        w = torch.softmax(torch.randn((bt, k), generator=gen, device=dev), 1)
        wv = w[:, None, :]
        for name, fn, lib in (
                ("gram", lambda: gram(x), lambda: torch.bmm(x, xt)),
                ("wsum", lambda: weighted_sum(x, w),
                 lambda: torch.bmm(wv, x))):
            t = cs.paired_ms(fn, lib, reps)
            hk, hl = [], []
            for _ in range(cs.ROUNDS):
                hk.append(host_us(fn, reps))
                hl.append(host_us(lib, reps))
                hl.append(host_us(lib, reps))
                hk.append(host_us(fn, reps))
            row = dict(name=name, shape=list(shape), label=args.label,
                       host_us=cs._median(hk), library_host_us=cs._median(hl),
                       **t)
            rows.append(row)
            print(f"[bench] {args.label} {name} {shape}: host "
                  f"{row['host_us']:.3f} us, issue {row['ms']:.6f} ms, "
                  f"device {row['device_ms']:.6f} ms; torch.bmm host "
                  f"{row['library_host_us']:.3f} us, issue "
                  f"{row['library_ms']:.6f} ms, device "
                  f"{row['library_device_ms']:.6f} ms", flush=True)
        del x, xt
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "label": args.label, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
