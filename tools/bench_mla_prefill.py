#!/usr/bin/env python3
"""MLA's serving prefill on the chunked route (the port before MLA ran on
the flash kernel) against the flash route, on the GPU.

    python3 tools/bench_mla_prefill.py [--rounds R] [--reps N]

Builds ``chip_smoke.serving_runs()``'s two MLA configurations at full
width, random weights from a seed: DeepSeek-V2-Lite cut to 4 layers (q/k
192, v 128: the flash kernel's hd-192 instance) and MiniCPM3-4B whole (62
layers, q/k 96, v 64: the hd-128 instance). For each prompt length of the
serving runs' buckets (1, 16, 128 and 256 tokens) it times the prefill's
forward (``model.forward`` with the cache collected and the last
position's logits, as ``model.prefill`` runs it) on ``attention="chunked"``
and ``attention="flash"``, in turns (chunked, flash, flash, chunked) for R
rounds of N calls each, by the host clock synchronised at both ends.
Prints the card's name and power limit, then for each configuration and
length the median ms per prefill on each route, the spread of the rounds,
the flash launches per call, and the largest logit gap between the routes
relative to max|logit|. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (1, 16, 128, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_mla_prefill: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import forward, init_params

    print(cs.card())
    dev = torch.device("cuda")
    configs = [
        ("deepseek-v2-lite_4l", dataclasses.replace(
            get_config("deepseek-v2-lite-16b"), n_layers=4)),
        ("minicpm3-4b", get_config("minicpm3-4b"))]
    for label, cfg in configs:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device=dev)
        for S in LENGTHS:
            tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                                   device=dev)

            def call(route):
                return forward(cfg, params, tokens, collect_cache=True,
                               last_only=True, attention=route)[0]

            logits = {}
            for route in ("chunked", "flash"):             # warm both
                dispatch.reset_launches()
                logits[route] = call(route)
                torch.cuda.synchronize()
                if route == "flash":
                    launches = dispatch.launch_counts()["flash_attention"]
            gap = (logits["flash"] - logits["chunked"]).abs().max().item()
            scale = logits["chunked"].abs().max().item()
            ms = {"chunked": [], "flash": []}
            for _ in range(args.rounds):
                for route in ("chunked", "flash", "flash", "chunked"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(args.reps):
                        call(route)
                    torch.cuda.synchronize()
                    ms[route].append((time.perf_counter() - t0) * 1e3
                                     / args.reps)
            med = {r: cs._median(v) for r, v in ms.items()}
            print(f"[mla-prefill] {label} S={S}: chunked "
                  f"{med['chunked']:.3f} ms ({min(ms['chunked']):.3f}–"
                  f"{max(ms['chunked']):.3f}), flash {med['flash']:.3f} ms "
                  f"({min(ms['flash']):.3f}–{max(ms['flash']):.3f}), "
                  f"flash/chunked {med['flash'] / med['chunked']:.3f}; "
                  f"flash launches {launches} ({cfg.n_layers} layers); "
                  f"logits gap {gap:.3e} = {gap / scale:.3e} of max|logit|",
                  flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
