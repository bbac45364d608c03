#!/usr/bin/env python3
"""Where one iteration of the port's DecByzPG spends its time on the GPU.

    python3 tools/profile_decbyzpg.py [--env cartpole|lunarlander]
                                      [--iters N] [--aggregator SPEC]
                                      [--agreement SPEC]

Runs ``repro_torch.core.decbyzpg.run_decbyzpg`` at ``chip_smoke.py``'s
full-width configurations (bucketing ∘ RFA and MDA unless
``--aggregator`` / ``--agreement`` name other rules, e.g. ``--aggregator
krum --agreement cwtm``): one warm iteration, then N iterations timed by
the host clock around a synchronised run, then N more under
``torch.profiler``. Prints the card, ms per iteration, and for each phase
range of the step (``decbyzpg.rollout`` ...) its host ms and the kernel
time of the kernels it launched, per iteration; the device-busy share
(kernel time over the profiled wall time); CUDA kernels per iteration;
and the ops with the most device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _configs():
    from repro_torch.core.decbyzpg import DecByzPGConfig
    from repro_torch.rl.envs import make_cartpole, make_lunarlander
    return {
        "cartpole": (make_cartpole(horizon=200),
                     DecByzPGConfig(n_byz=3, attack="large_noise(sigma=10)")),
        "lunarlander": (make_lunarlander(),
                        DecByzPGConfig(hidden=(64, 64), activation="tanh")),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", choices=("cartpole", "lunarlander"),
                    default="cartpole")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--aggregator", default=None,
                    help="aggregator spec, e.g. krum or trimmed_mean")
    ap.add_argument("--agreement", default=None,
                    help="agreement spec, e.g. cwtm or cwmed")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_decbyzpg: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.decbyzpg import run_decbyzpg
    from repro_torch.kernels import dispatch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    env, cfg = _configs()[args.env]
    rules = {k: v for k, v in (("aggregator", args.aggregator),
                               ("agreement", args.agreement)) if v}
    cfg = dataclasses.replace(cfg, **rules)
    n = args.iters
    run_decbyzpg(env, cfg, 1)                    # build kernels, warm up
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    out = run_decbyzpg(env, cfg, n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    d = out["theta"].shape[1]
    print(f"[profile] {args.env} aggregator={cfg.aggregator} "
          f"agreement={cfg.agreement} d={d} K={cfg.K} horizon={env.horizon} "
          f"M={max(cfg.N, cfg.B)}: {wall:.3f} ms/iter over {n} iterations "
          f"(host clock, synchronised)")
    print(f"[profile] our kernels per iteration: "
          f"{ {k: v / n for k, v in dispatch.launch_counts().items()} }")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_decbyzpg(env, cfg, n)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3

    # device-side events: the kernels (and copies), and the GPU spans of
    # the step's profiler ranges, which cover kernels and are not counted
    # as busy time; each kernel is attributed to the range it starts in
    events = prof.events()
    device = [e for e in events if str(e.device_type).endswith("CUDA")]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device if e.name.startswith("decbyzpg."))
    kernels = [e for e in device if not e.name.startswith("decbyzpg.")]
    starts = [sp[0] for sp in spans]
    phase_dev = {}
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        inside = i >= 0 and k.time_range.start < spans[i][1]
        name = spans[i][2] if inside else "(outside the step's ranges)"
        phase_dev[name] = phase_dev.get(name, 0.0) + (
            k.time_range.end - k.time_range.start) / 1e3
    phase_host = {}
    for e in events:
        if e.name.startswith("decbyzpg.") \
                and not str(e.device_type).endswith("CUDA"):
            phase_host[e.name] = phase_host.get(e.name, 0.0) \
                + e.cpu_time_total / 1e3
    kernel_ms = sum(phase_dev.values())
    print(f"[profile] profiled wall {prof_wall / n:.3f} ms/iter; device "
          f"{len(kernels) / n:.0f} kernels/iter, {kernel_ms / n:.3f} "
          f"ms/iter of kernel time")
    if kernel_ms > 0:
        print(f"[profile] device busy {kernel_ms / prof_wall:.4f} of the "
              f"profiled wall time, idle {1 - kernel_ms / prof_wall:.4f}")
    else:
        print("[profile] device time: not measured (the profiler recorded "
              "no CUDA kernel)")
    print("[profile] phase                        host ms/iter  "
          "kernel ms/iter")
    for name in sorted(set(phase_host) | set(phase_dev),
                       key=lambda nm: -phase_host.get(nm, 0.0)):
        print(f"[profile] {name:30s} {phase_host.get(name, 0.0) / n:12.3f}"
              f"  {phase_dev.get(name, 0.0) / n:14.3f}")
    avg = [a for a in prof.key_averages()
           if not a.key.startswith("decbyzpg.")]
    top = sorted(avg, key=lambda a: -a.self_device_time_total)[:12]
    print("[profile] top ops by self device time (ms/iter, calls/iter):")
    for a in top:
        print(f"[profile]   {a.key[:60]:60s} "
              f"{a.self_device_time_total / 1e3 / n:9.3f} "
              f"{a.count / n:8.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
