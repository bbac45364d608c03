#!/usr/bin/env python3
"""Times the coordinate-wise reduce kernels of one source tree of the port
on the GPU: ``gossip_reduce``, ``neighbor_reduce`` and ``trimmed_mean``.

    python3 tools/bench_cw.py [--src DIR] [--label NAME] [--sweep-p]
                              [--sass] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees, e.g. a parent commit unpacked by ``git archive`` and the
working tree, can be measured in one call in turns (parent, change,
change, parent). For each input: the issue-bound time
(``chip_smoke.time_ms``) and the device time (a CUDA graph of the calls,
``chip_smoke.GraphTimer``) of the kernel and of its PyTorch yardstick
(``chip_smoke._library_reduce``: ``torch.sort`` and a slice mean, on the
gathered tensor for ``gossip_reduce``), in turns, medians over
``chip_smoke.ROUNDS`` rounds, with ``chip_smoke.bound`` (one operation per
compare, P² a coordinate, P for the mean) and the device time's share of
it. Inputs: the main path's (the runs of ``chip_smoke.main_runs()``) and
``chip_smoke.LARGE_CW``'s; the launch-weighted loss of the headlines,
launches in ``main_runs()`` × (device ms − bound ms).

``--sweep-p`` times instead ``gossip_reduce`` (median) over 13 receivers
of 2^22 coordinates for P = 1, 2, 5, 7, 8, 9, 13, 16, 17, 24, 32 (random
neighbour tables). ``--sass`` counts the instructions of every cw kernel
in the built library (``cuobjdump -sass``), and gives their registers and
spills from the build's ``ptxas -v`` report (a fresh build). Prints the
card, one line per input and one JSON object last (also written to
``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_P = (1, 2, 5, 7, 8, 9, 13, 16, 17, 24, 32)


def launches_per_run():
    """Launches of each cw kernel over ``chip_smoke.main_runs()``."""
    import chip_smoke as cs
    out = Counter()
    for _, _, T, _, per_iter in cs.main_runs():
        for name, n in per_iter.items():
            out[name] += n * T
    return out


def inputs(dev, gen):
    """(name, label, fn, library, bound (ms, by), headline) of the default
    inputs."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.gossip_reduce import gossip_reduce, \
        neighbor_reduce
    from repro_torch.kernels.trimmed_mean import trimmed_mean
    from repro_torch.topology import resolve_topology
    nbr = torch.as_tensor(resolve_topology("complete", 13).nbr_idx,
                          dtype=torch.int64, device=dev)
    k, p = nbr.shape
    cases = []
    for d, mode, nt in ((386, "trimmed", 3), (4868, "mean", 0),
                        (cs.LARGE_CW["gossip_d"], "trimmed", 3)):
        msgs = torch.randn((k, d), generator=gen, device=dev)
        ops = k * d * (p if mode == "mean" else p * p)
        cases.append(("gossip_reduce", f"({k}, {d}) P={p} {mode}",
                      lambda m=msgs, md=mode, t=nt: gossip_reduce(m, nbr, md,
                                                                  t),
                      lambda m=msgs, md=mode, t=nt: cs._library_reduce(
                          m[nbr], md, t),
                      cs.bound(4 * 2 * k * d + 8 * k * p, ops), d == 386))
    for d in (386, cs.LARGE_CW["neighbor_d"]):
        recv = torch.randn((k, p, d), generator=gen, device=dev)
        cases.append(("neighbor_reduce", f"({k}, {p}, {d}) median",
                      lambda r=recv: neighbor_reduce(r, "median", 0),
                      lambda r=recv: cs._library_reduce(r, "median", 0),
                      cs.bound(4 * (k * p * d + k * d), k * d * p * p),
                      d == 386))
    for d in (386, cs.LARGE_CW["trimmed_d"]):
        x = torch.randn((1, 13, d), generator=gen, device=dev)
        cases.append(("trimmed_mean", f"(1, 13, {d}) n_trim=3",
                      lambda x=x: trimmed_mean(x, 3),
                      lambda x=x: cs._library_reduce(x, "trimmed", 3),
                      cs.bound(4 * (13 * d + d), d * 13 * 13), d == 386))
    return cases


def device_ms(fn, reps):
    import chip_smoke as cs
    timer = cs.GraphTimer(fn, reps)
    return cs._median([timer.ms() for _ in range(cs.ROUNDS)])


#: the kernels this tool reports on (a regular expression on their names)
CW_KERNELS = r"gossip|neighbor|trimmed"


def sass_counts(lib: Path, pattern: str = CW_KERNELS) -> list:
    """Instructions of every kernel whose name matches ``pattern`` in
    ``lib`` (``cuobjdump -sass``, beside the ``nvcc`` that built it): the
    total and the compares, adds, shuffles, special functions, loads and
    local-memory accesses."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    rows, name, ops = [], None, Counter()
    for line in out.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name and re.search(pattern, name):
                rows.append(dict(function=name, **ops))
            name, ops = m.group(1), Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name:
            op = m.group(2).split(".")[0]
            ops["total"] += 1
            if op in ("FSET", "FSETP", "ISETP", "IADD3", "LDS", "SEL",
                      "FADD", "FMUL", "FFMA", "SHFL", "MUFU", "LDG", "BRA",
                      "STL", "LDL"):
                ops[op] += 1
    return rows


def ptxas_counts(report: str, pattern: str = CW_KERNELS) -> list:
    """Registers, stack frame and spill bytes of every kernel whose name
    matches ``pattern`` in a build's ``ptxas -v`` report."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and name and re.search(pattern, name):
            rows.append(dict(function=name, stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3))))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["function"] == name:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep-p", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_cw: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[bench] {args.label}: {card}; repro_torch from "
          f"{sys.modules['repro_torch'].__file__}", flush=True)
    _build.build()
    print(f"[bench] {args.label}: build {_build.BUILD_INFO['seconds']:.2f} s",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    result = {"card": card, "label": args.label, "rows": []}
    rows = result["rows"]
    if args.sass:
        for r in ptxas_counts(_build.BUILD_INFO["ptxas"]):
            rows.append(dict(kind="ptxas", **r))
            print(f"[ptxas] {args.label} {r}", flush=True)
        for r in sass_counts(_build.library_path()):
            rows.append(dict(kind="sass", **r))
            print(f"[sass] {args.label} {r}", flush=True)
    if args.sweep_p:
        from repro_torch.kernels.gossip_reduce import gossip_reduce
        k, d = 13, 1 << 22
        msgs = torch.randn((k, d), generator=gen, device=dev)
        for p in SWEEP_P:
            nbr = torch.randint(0, k, (k, p), generator=gen, device=dev)
            ms = device_ms(lambda: gossip_reduce(msgs, nbr, "median", 0), 3)
            b = cs.bound(4 * 2 * k * d + 8 * k * p, k * d * p * p)
            rows.append(dict(kind="sweep", p=p, device_ms=ms, bound_ms=b[0],
                             bound_by=b[1]))
            print(f"[sweep] {args.label} gossip_reduce ({k}, {d}) P={p} "
                  f"median: device {ms:.6f} ms, bound {b[0]:.6f} ms "
                  f"({b[1]}), {b[0] / ms:.1%} of the bound", flush=True)
        del msgs
    if not (args.sweep_p or args.sass):
        launches = launches_per_run()
        loss = 0.0
        for name, label, fn, lib, (b, by), head in inputs(dev, gen):
            reps = 200 if head or "4868" in label else 3
            t = cs.paired_ms(fn, lib, reps)
            row = dict(kind="input", name=name, input=label, headline=head,
                       bound_ms=b, bound_by=by, **t)
            if head:
                row["launches"] = launches[name]
                row["loss_ms"] = launches[name] * (t["device_ms"] - b)
                loss += row["loss_ms"]
            rows.append(row)
            print(f"[bench] {args.label} {name} {label}: issue "
                  f"{t['ms']:.6f} ms, device {t['device_ms']:.6f} ms, bound "
                  f"{b:.7f} ms ({by}), {b / t['device_ms']:.2%} of the "
                  f"bound; library issue {t['library_ms']:.6f} ms, device "
                  f"{t['library_device_ms']:.6f} ms", flush=True)
            torch.cuda.empty_cache()
        result["loss_ms"] = loss
        print(f"[bench] {args.label} launch-weighted loss of the headlines: "
              f"{loss:.6f} ms ({dict(launches)})", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
