#!/usr/bin/env python3
"""Times ``weiszfeld`` and ``krum_score`` of one source tree of the port on
the GPU.

    python3 tools/bench_rfa_krum.py [--src DIR] [--label NAME] [--sweep-k]
                                    [--sass] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees, e.g. a parent commit unpacked by ``git archive`` and the
working tree, can be measured in one call in turns (parent, change,
change, parent). Prints the card's name and power limit first. For each
input: the issue-bound time (``chip_smoke.time_ms``) and the device time
(a CUDA graph of the calls, ``chip_smoke.GraphTimer``), medians over
``chip_smoke.ROUNDS`` rounds, with ``chip_smoke.bound`` and the device
time's share of it; ``krum_score`` also beside its PyTorch yardstick
(``chip_smoke._library_krum``: ``torch.sort`` of D² and a slice sum), in
turns. Inputs: ``weiszfeld`` (n_iter 32, nu 1e-6) on the Gram matrices of
``chip_smoke.MAIN_SHAPES`` and ``LARGE_SHAPES``, ``krum_score`` at the five
inputs of ``chip_smoke.phase_cw_kernels``; the launch-weighted loss of the
headlines, launches in ``chip_smoke.main_runs()`` × (device ms − bound
ms); and the launch's floor: the device ms of a one-element ``x.add_(0)``
replayed from the same kind of graph.

``--sweep-k`` times instead both kernels' device ms at K = 1, 4, 5, 7, 8,
9, 13, 16, 17, 24, 32, the edges of their instances: ``weiszfeld`` on 13
Gram matrices, ``krum_score`` on about 709 MB of them (as many as 2^20
matrices of 13). ``--sass`` counts the instructions of every instance
(``cuobjdump -sass``) and gives their registers and spills from the build's
``ptxas -v`` report (a fresh build). One JSON object last (also written to
``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_K = (1, 4, 5, 7, 8, 9, 13, 16, 17, 24, 32)
N_ITER, NU = 32, 1e-6
KERNELS = r"weiszfeld|krum"


def launches_per_run():
    """Launches of each kernel over ``chip_smoke.main_runs()``."""
    import chip_smoke as cs
    out = Counter()
    for _, _, T, _, per_iter in cs.main_runs():
        for name, n in per_iter.items():
            out[name] += n * T
    return out


def weiszfeld_bound(bt, k):
    import chip_smoke as cs
    return cs.bound(4 * (bt * k * k + bt * k),
                    N_ITER * bt * (2 * k * k + 8 * k))


def krum_bound(bt, k):
    import chip_smoke as cs
    return cs.bound(4 * (bt * k * k + bt * k), bt * k * k * k)


def krum_inputs(dev, gen):
    """(label, g, n_near, headline) of ``phase_cw_kernels``' inputs."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.pairwise_dist import gram
    out = []
    for (bt, k, d), n_near, grid in [((1, 13, 386), 8, False),
                                     ((1, 13, 4868), 10, False),
                                     ((13, 5, 386), 2, False),
                                     ((1, 13, 386), 8, True)]:
        if grid:
            x = torch.randint(-4, 5, (bt, k, d), generator=gen,
                              device=dev).float()
        else:
            x = torch.randn((bt, k, d), generator=gen, device=dev)
        label = f"x {(bt, k, d)} n_near={n_near}" + (" grid" if grid else "")
        out.append((label, gram(x), n_near,
                    label == cs.HEADLINE["krum_score"]))
    bt = cs.LARGE_CW["krum_bt"]
    x = torch.randn((bt, 13, 16), generator=gen, device=dev)
    out.append((f"G {(bt, 13, 13)} n_near=8",
                torch.matmul(x, x.transpose(1, 2)), 8, False))
    return out


def device_ms(fn, reps):
    import chip_smoke as cs
    timer = cs.GraphTimer(fn, reps)
    return cs._median([timer.ms() for _ in range(cs.ROUNDS)])


def launch_floor(dev):
    import torch
    x = torch.zeros(1, device=dev)
    return device_ms(lambda: x.add_(0), 200)


def run_inputs(args, dev, gen, rows):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.krum_score import krum_score
    from repro_torch.kernels.pairwise_dist import gram
    from repro_torch.kernels.rfa import weiszfeld_weights
    launches = launches_per_run()
    loss = {}
    for shape in cs.MAIN_SHAPES + cs.LARGE_SHAPES:
        bt, k, d = shape
        g = gram(torch.randn(shape, generator=gen, device=dev) + 1.5)
        torch.cuda.empty_cache()
        t = cs.paired_ms(lambda: weiszfeld_weights(g, NU, N_ITER), None, 200)
        b, by = weiszfeld_bound(bt, k)
        head = shape == cs.HEADLINE["weiszfeld"]
        row = dict(kind="input", name="weiszfeld", input=str(shape),
                   headline=head, bound_ms=b, bound_by=by, **t)
        if head:
            row["launches"] = launches["weiszfeld"]
            loss["weiszfeld"] = launches["weiszfeld"] * (t["device_ms"] - b)
        rows.append(row)
        print(f"[bench] {args.label} weiszfeld G of {shape}: issue "
              f"{t['ms']:.6f} ms, device {t['device_ms']:.6f} ms, bound "
              f"{b:.8f} ms ({by}), {b / t['device_ms']:.4%} of the bound",
              flush=True)
    for label, g, n_near, head in krum_inputs(dev, gen):
        bt, k, _ = g.shape
        large = bt > 1000
        t = cs.paired_ms(lambda: krum_score(g, n_near),
                         lambda: cs._library_krum(g, n_near),
                         3 if large else 200)
        b, by = krum_bound(bt, k)
        row = dict(kind="input", name="krum_score", input=label,
                   headline=head, bound_ms=b, bound_by=by, **t)
        if head:
            row["launches"] = launches["krum_score"]
            loss["krum_score"] = launches["krum_score"] * (t["device_ms"] - b)
        rows.append(row)
        print(f"[bench] {args.label} krum_score {label}: issue "
              f"{t['ms']:.6f} ms, device {t['device_ms']:.6f} ms, bound "
              f"{b:.8f} ms ({by}), {b / t['device_ms']:.4%} of the bound; "
              f"torch.sort issue {t['library_ms']:.6f} ms, device "
              f"{t['library_device_ms']:.6f} ms", flush=True)
        del g
        torch.cuda.empty_cache()
    floor = launch_floor(dev)
    rows.append(dict(kind="floor", device_ms=floor))
    print(f"[bench] {args.label} launch floor (one-element add_ from a "
          f"graph): device {floor:.6f} ms", flush=True)
    print(f"[bench] {args.label} launch-weighted loss: "
          f"{ {n: round(v, 6) for n, v in loss.items()} } ms "
          f"(launches {dict(launches)})", flush=True)
    return loss


def run_sweep(args, dev, gen, rows):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.krum_score import krum_score
    from repro_torch.kernels.pairwise_dist import gram
    from repro_torch.kernels.rfa import weiszfeld_weights
    for k in SWEEP_K:
        g = gram(torch.randn((13, k, 386), generator=gen, device=dev) + 1.5)
        ms = device_ms(lambda: weiszfeld_weights(g, NU, N_ITER), 200)
        rows.append(dict(kind="sweep", name="weiszfeld", k=k, bt=13,
                         device_ms=ms))
        # any matrices time alike: the rank network's work does not depend
        # on the values (none is NaN or infinite here)
        bt = cs.LARGE_CW["krum_bt"] * 169 // (k * k)
        g = torch.randn((bt, k, k), generator=gen, device=dev)
        n_near = max(k - 5, 1)
        kms = device_ms(lambda: krum_score(g, n_near), 3)
        b, by = krum_bound(bt, k)
        rows.append(dict(kind="sweep", name="krum_score", k=k, bt=bt,
                         n_near=n_near, device_ms=kms, bound_ms=b,
                         bound_by=by))
        print(f"[sweep] {args.label} K={k}: weiszfeld (13, {k}, {k}) device "
              f"{ms:.6f} ms; krum_score ({bt}, {k}, {k}) n_near={n_near} "
              f"device {kms:.6f} ms, bound {b:.6f} ms ({by}), "
              f"{b / kms:.1%} of the bound", flush=True)
        del g
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep-k", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_rfa_krum: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[bench] {args.label}: {card}", flush=True)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    print(f"[bench] {args.label}: repro_torch from "
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
        from bench_cw import ptxas_counts, sass_counts
        for r in ptxas_counts(_build.BUILD_INFO["ptxas"], KERNELS):
            rows.append(dict(kind="ptxas", **r))
            print(f"[ptxas] {args.label} {r}", flush=True)
        for r in sass_counts(_build.library_path(), KERNELS):
            rows.append(dict(kind="sass", **r))
            print(f"[sass] {args.label} {r}", flush=True)
    if args.sweep_k:
        run_sweep(args, dev, gen, rows)
    if not (args.sweep_k or args.sass):
        result["loss_ms"] = run_inputs(args, dev, gen, rows)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
