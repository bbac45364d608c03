#!/usr/bin/env python3
"""Times the flash-attention kernel of one source tree of the port on the
GPU.

    python3 tools/bench_flash.py [--src DIR] [--label NAME] [--sdpa]
                                 [--buckets] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees, e.g. a parent commit unpacked by ``git archive`` and the
working tree, can be measured in one call in turns (parent, change,
change, parent). Every input of ``chip_smoke.FLASH_CASES`` and
``FLASH_LARGE`` is timed two ways, in turns: ``folded``, the entry point
``flash_attention_kernel(q, k, v, H, window)`` on contiguous (B·H, S, hd)
tensors, which every tree has; and ``layout``, the call the serving path
makes on the model's contiguous (B, S, H, hd) tensors,
``ops.flash_attention(q, k, v, window).reshape(B, S, H·hd)`` (one strided
launch on a tree whose kernel takes strides; the fold and unfold copies
around the folded launch on one that does not). Each has its issue-bound
time (``chip_smoke.time_ms``) and its device time (a CUDA graph of the
calls, ``chip_smoke.GraphTimer``), medians over ``chip_smoke.ROUNDS``
rounds, beside the bound of ``chip_smoke.py``. ``--sdpa`` also times f32
``scaled_dot_product_attention`` on the same inputs, in the same turns.
Each input is first held against the plain version both ways
(2e-5·max|v|, as in ``chip_smoke.py``). ``--buckets`` times instead the
inputs of ``chip_smoke.serving_runs()``: every prefill bucket of each
run, with its flash launches in that run (layers × (one warmup prefill +
the requests in the bucket)), and the launch-weighted loss of each way,
the sum over buckets of launches × (device ms − bound ms). Prints the
card, one line per input and one JSON object last (also written to
``--out``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def bucket_cases():
    """((1, H, Hkv, S, hd, None), launches) for every prefill bucket of
    ``chip_smoke.serving_runs()``: the engine prefills each bucket once in
    its warmup and then every request whose prompt falls in it (the
    policy's requests carry no tokens: bucket 1); S counts the model's
    prefix embeddings too."""
    import chip_smoke as cs
    from repro_torch.rl.transformer_policy import transformer_policy_config
    from repro_torch.serving import default_buckets, make_traffic
    out = []
    for _, cfg, kw, n, lens, _ in cs.serving_runs():
        if cfg is None:       # serve()'s default policy
            cfg = transformer_policy_config("llama3.2-1b", n_layers=2,
                                            d_model=64, n_heads=2)
            buckets, prompts = default_buckets(8), [1] * n
        else:
            buckets = default_buckets(kw["max_prompt"])
            prompts = [len(r.tokens) for r in make_traffic(
                n, seed=0, vocab=cfg.vocab_size, prompt_lens=lens,
                max_new=kw["max_new"])]
        served = [min(b for b in buckets if b >= p) for p in prompts]
        for b in buckets:
            out.append(((1, cfg.n_heads, cfg.n_kv_heads,
                         cfg.n_prefix_embeds + b, cfg.resolved_head_dim,
                         None), cfg.n_layers * (1 + served.count(b))))
    return out


def turns(fns: dict, reps: int) -> dict:
    """{name: (issue ms, device ms)}: each function's issue-bound and
    device times, medians over ``chip_smoke.ROUNDS`` rounds that run the
    functions in order and then in reverse."""
    import chip_smoke as cs
    order = list(fns) + list(fns)[::-1]
    issue = {n: [] for n in fns}
    for _ in range(cs.ROUNDS):
        for n in order:
            issue[n].append(cs.time_ms(fns[n], reps))
    timers = {n: cs.GraphTimer(fn, reps) for n, fn in fns.items()}
    device = {n: [] for n in fns}
    for _ in range(cs.ROUNDS):
        for n in order:
            device[n].append(timers[n].ms())
    return {n: (cs._median(issue[n]), cs._median(device[n])) for n in fns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--buckets", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    print(f"[bench] {args.label}: {card}; repro_torch from "
          f"{sys.modules['repro_torch'].__file__}; build "
          f"{_build.BUILD_INFO['seconds']:.2f} s", flush=True)
    for line in _build.BUILD_INFO["ptxas"].splitlines():
        if "flash" in line or "Used" in line:
            print(f"[bench] {args.label} ptxas {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = []
    cases = bucket_cases() if args.buckets else [
        (case, None) for case in cs.FLASH_CASES + [cs.FLASH_LARGE]]
    for case, launches in cases:
        B, H, Hkv, S, hd, window = case
        large = case == cs.FLASH_LARGE
        q = torch.randn((B * H, S, hd), generator=gen, device=dev)
        k = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        v = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        q4, k4, v4 = (x.reshape(B, -1, S, hd) for x in (q, k, v))
        qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q4, k4, v4))
        fns = {"folded": lambda: flash_attention_kernel(q, k, v, H, window),
               "layout": lambda: flash_attention(qm, km, vm, window
                                                 ).reshape(B, S, H * hd)}
        if args.sdpa and window is None:
            fns["sdpa"] = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=True)
        elif args.sdpa:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) \
                & ((pos[:, None] - pos[None, :]) < window)
            fns["sdpa"] = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True)
        ref = flash_attention_plain(q, k, v, H, window)
        err = max((fns["folded"]() - ref).abs().max().item(),
                  (fns["layout"]() - ref.reshape(B, H, S, hd).transpose(1, 2)
                   .reshape(B, S, H * hd)).abs().max().item())
        if not err <= 2e-5 * v.abs().max().item():
            raise AssertionError(f"{args.label} {case}: max abs err {err} "
                                 f"against the plain version")
        t = turns(fns, 5 if large else 100)
        pairs = B * H * cs._flash_pairs(S, window)
        b = cs.bound(4 * (2 * B * H * S * hd + 2 * B * Hkv * S * hd),
                     4 * hd * pairs)
        row = dict(case=list(case), label=args.label, bound_ms=b[0],
                   bound_by=b[1], launches=launches, max_abs_err=err,
                   ms=t["folded"][0], device_ms=t["folded"][1],
                   layout_ms=t["layout"][0], layout_device_ms=t["layout"][1],
                   sdpa_ms=t.get("sdpa", (None,))[0],
                   sdpa_device_ms=t.get("sdpa", (None, None))[1])
        rows.append(row)
        lib = "" if not args.sdpa else (
            f"; SDPA issue {row['sdpa_ms']:.6f} ms, device "
            f"{row['sdpa_device_ms']:.6f} ms")
        n = "" if launches is None else f", {launches} launches"
        print(f"[bench] {args.label} flash {case}{n}: folded issue "
              f"{row['ms']:.6f} ms, device {row['device_ms']:.6f} ms; layout "
              f"issue {row['layout_ms']:.6f} ms, device "
              f"{row['layout_device_ms']:.6f} ms; bound {b[0]:.6f} ms "
              f"({b[1]}), {b[0] / row['device_ms']:.1%} of the bound folded, "
              f"{b[0] / row['layout_device_ms']:.1%} by layout{lib}",
              flush=True)
        del q, k, v, q4, k4, v4, qm, km, vm, fns
        torch.cuda.empty_cache()
    if args.buckets:
        for way, key in (("folded", "device_ms"), ("layout",
                                                   "layout_device_ms")):
            loss = sum(r["launches"] * (r[key] - r["bound_ms"])
                       for r in rows)
            print(f"[bench] {args.label} launch-weighted loss ({way}) over "
                  f"the serving runs' {sum(r['launches'] for r in rows)} "
                  f"flash launches: {loss:.6f} ms")
    result = {"card": card, "label": args.label, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
