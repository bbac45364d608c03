#!/usr/bin/env python3
"""Where the port's serving of Llama-3.2-1B spends its time on the GPU.

    python3 tools/profile_serve.py [--requests N] [--slots S]
                                   [--max-prompt P] [--max-new M]
                                   [--src DIR] [--label NAME]

Builds ``chip_smoke.py``'s ``llama3.2-1b_serve`` run: Llama-3.2-1B at full
width and depth with the port's own init (``torch.Generator``, seed 0),
f32, ``DecodeEngine(slots=8, max_prompt=512, max_new=32)`` and
``make_traffic(24, seed=0, prompt_lens=(1, 16, 128, 512), max_new=32)``.
After the engine's warmup it serves the traffic once timed by the host
clock, then once more under ``torch.profiler``. Prints the card; the
run's summary with its ms per tick and per prefill by bucket
(``chip_smoke._PhaseTimes``); for each range of the engine
(``serve.prefill``, ``serve.insert``, ``serve.tick``) its calls, host
ms and the kernel time of the kernels launched inside it, in total and
per call; CUDA kernels per tick; the device's busy and idle shares of
the profiled wall time; and the ops with the most device time. ``--src``
imports ``repro_torch`` from another tree (e.g. a parent commit unpacked by
``git archive``), so that two trees can be compared in one call in turns.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RANGES = ("serve.prefill", "serve.insert", "serve.tick")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    from repro_torch.serving import DecodeEngine, PolicyServer, make_traffic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; {args.label}: repro_torch from "
          f"{sys.modules['repro_torch'].__file__}")
    dev = torch.device("cuda")
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    engine = DecodeEngine(cfg, init_params(cfg, gen, device=dev),
                          slots=args.slots, max_prompt=args.max_prompt,
                          max_new=args.max_new, device=dev)
    lens = tuple(p for p in (1, 16, 128, 512) if p <= args.max_prompt)
    traffic = make_traffic(args.requests, seed=0, vocab=cfg.vocab_size,
                           prompt_lens=lens, max_new=args.max_new)
    PolicyServer(engine)                             # builds, warms up
    torch.cuda.synchronize()
    dispatch.reset_launches()
    with chip_smoke._PhaseTimes() as times:
        t0 = time.perf_counter()
        report = PolicyServer(engine, warmup=False).run_offline(traffic)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(f"[profile] llama3.2-1b_serve slots={args.slots} "
          f"max_prompt={args.max_prompt} max_new={args.max_new} "
          f"requests={args.requests}: {wall:.3f} ms (host clock, "
          f"synchronised) {report.summary()} {times.summary()}")
    print(f"[profile] our kernels: {dispatch.launch_counts()}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PolicyServer(engine, warmup=False).run_offline(traffic)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3

    # device events: kernels and copies, plus the GPU spans of the
    # engine's ranges, which cover kernels and are not busy time; each
    # kernel is attributed to the range it starts in
    events = prof.events()
    device = [e for e in events if str(e.device_type).endswith("CUDA")]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device if e.name in RANGES)
    kernels = [e for e in device if e.name not in RANGES]
    starts = [sp[0] for sp in spans]
    dev_ms, dev_n = {}, {}
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        inside = i >= 0 and k.time_range.start < spans[i][1]
        name = spans[i][2] if inside else "(outside the engine's ranges)"
        dev_ms[name] = dev_ms.get(name, 0.0) + (
            k.time_range.end - k.time_range.start) / 1e3
        dev_n[name] = dev_n.get(name, 0) + 1
    host_ms, calls = {}, {}
    for e in events:
        if e.name in RANGES and not str(e.device_type).endswith("CUDA"):
            host_ms[e.name] = host_ms.get(e.name, 0.0) \
                + e.cpu_time_total / 1e3
            calls[e.name] = calls.get(e.name, 0) + 1
    busy = sum(dev_ms.values())
    print(f"[profile] profiled wall {prof_wall:.3f} ms; device "
          f"{len(kernels)} kernels, {busy:.3f} ms of kernel time")
    if busy > 0:
        print(f"[profile] device busy {busy / prof_wall:.4f} of the "
              f"profiled wall time, idle {1 - busy / prof_wall:.4f}")
    else:
        print("[profile] device time: not measured (the profiler recorded "
              "no CUDA kernel)")
    print("[profile] range            calls  host ms  kernel ms  "
          "host ms/call  kernel ms/call  kernels/call")
    for name in sorted(set(host_ms) | set(dev_ms),
                       key=lambda nm: -host_ms.get(nm, 0.0)):
        n = max(calls.get(name, 0), 1)
        print(f"[profile] {name:30s} {calls.get(name, 0):5d} "
              f"{host_ms.get(name, 0.0):9.3f} {dev_ms.get(name, 0.0):9.3f} "
              f"{host_ms.get(name, 0.0) / n:12.3f} "
              f"{dev_ms.get(name, 0.0) / n:14.3f} "
              f"{dev_n.get(name, 0) / n:12.1f}")
    avg = [a for a in prof.key_averages() if a.key not in RANGES]
    top = sorted(avg, key=lambda a: -a.self_device_time_total)[:12]
    print("[profile] top ops by self device time (ms, calls):")
    for a in top:
        print(f"[profile]   {a.key[:60]:60s} "
              f"{a.self_device_time_total / 1e3:9.3f} {a.count:8d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
