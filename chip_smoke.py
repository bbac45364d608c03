#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is non-zero):

1. Card: the GPU's name and power limit, as ``nvidia-smi`` reports them.
2. Build: every ``kernels/csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one
   compile per source in parallel, linked into one library.
3. Kernels: ``gram``, ``weiszfeld`` and ``wsum``, then ``krum_score``,
   ``trimmed_mean``, ``gossip_reduce`` and ``neighbor_reduce`` (each mode)
   against their plain PyTorch versions on the card, at the main path's
   shapes and one large input each; every kernel is rerun for
   bit-identity, and one integer-grid input per kernel must match its
   plain version bit for bit; mean times of the kernel, the plain version
   and a library yardstick (``torch.bmm``, or ``torch.sort`` plus a slice
   mean or sum; timed only, never called by the port).
4. Main path: ``run_decbyzpg`` at full width, five runs (``main_runs()``):
   the paper's CartPole configuration (K=13, n_byz=3
   ``large_noise(sigma=10)``, bucketing ∘ RFA, MDA κ=6, horizon 200,
   d=386) for 8 iterations, LunarLander with a (64, 64) tanh policy
   (d=4868) for 3, CartPole with Krum and cwtm, CartPole with the trimmed
   mean and cwmed under per-receiver equivocation, and LunarLander with
   Krum and cwmean. Each run's launches per iteration must equal its
   row, and every kernel must launch on at least one run. Small
   configurations (RFA/MDA, Krum/cwtm, trimmed mean/cwmed per receiver)
   then run on the card and, with the same draws, on the CPU through the
   plain versions, and the two must agree.
5. Serving (``serving_runs()``): the port's continuous-batching engine
   serves Llama-3.2-1B at full width and depth (24 requests, prompts up to
   512 tokens), Qwen2.5-3B at full width cut to 4 layers, and the default
   transformer policy through ``serve()``; each run must launch flash
   attention exactly once per layer per prefill (warmup included) and
   give every request exactly its budget of in-range tokens. Then
   Llama-3.2-1B's width at 2 layers serves the same requests with the
   same weights on the card and on the CPU: prefill logits must agree,
   and greedy streams wherever the top-1 margin exceeds the tolerance.
   Every registered kernel must launch on some run of phases 4 and 5.
6. The kernel table as one JSON line, then
   ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the JAX package ``repro``. Without a CUDA
device, or outside a checkout that holds ``src/repro_torch``, it exits 2
and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the FP32 rate outside the
# tensor cores (the kernels use FP32 FMA; TF32 is off)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

MAIN_SHAPES = [(13, 13, 386), (13, 7, 386), (13, 13, 4868), (13, 7, 4868)]
LARGE_SHAPE = (1, 13, 1 << 24)
# the large input of each cw kernel, a few hundred MB: Krum's scoring over
# 2^20 Gram matrices of 13 agents, the trimmed mean of 13 stacks of 2^24,
# the gossip reduces of 13 agents' messages of 2^22 and 2^20 coordinates
LARGE_CW = {"krum_bt": 1 << 20, "trimmed_d": 1 << 24, "gossip_d": 1 << 22,
            "neighbor_d": 1 << 20}
SOURCE = "src/repro_torch/kernels/csrc/aggregation.cu"
SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/attention.cu"}
REPLACES = {
    "gram": "src/repro/kernels/pairwise_dist/pairwise_dist.py:30",
    "weiszfeld": "src/repro/kernels/rfa/rfa.py:76",
    "wsum": "src/repro/kernels/rfa/rfa.py:86",
    "krum_score": "src/repro/kernels/krum_score/krum_score.py:44",
    "trimmed_mean": "src/repro/kernels/trimmed_mean/trimmed_mean.py:29",
    "gossip_reduce": "src/repro/kernels/gossip_reduce/gossip_reduce.py:50",
    "neighbor_reduce":
        "src/repro/kernels/gossip_reduce/gossip_reduce.py:80",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:68",
}
# the input each kernel sees most on the main path: gram from MDA's rounds
# and weiszfeld and wsum on the 7 bucket means (CartPole, n_byz=3); the
# Krum, trimmed-mean and cw* kernels at the CartPole runs of main_runs()
HEADLINE = {"gram": (13, 13, 386), "weiszfeld": (13, 7, 386),
            "wsum": (13, 7, 386),
            "krum_score": "x (1, 13, 386) n_near=8",
            "trimmed_mean": "(1, 13, 386) n_trim=3",
            "gossip_reduce": "(13, 386) P=13 trimmed n_trim=3",
            "neighbor_reduce": "(13, 13, 386) median",
            "flash_attention": "q (32, 512, 64) kv (8, 512, 64)"}
# flash inputs (B, H, Hkv, S, hd, window): Llama-3.2-1B's 512-token
# prefill (G = 4) with and without windows, Qwen2.5-3B's (hd 128, G = 8),
# the policy's 9-position prefill (hd 32, G = 1) and ragged grouped ones
FLASH_CASES = [(1, 32, 8, 512, 64, None), (1, 32, 8, 512, 64, 1),
               (1, 32, 8, 512, 64, 7), (1, 32, 8, 512, 64, 128),
               (1, 16, 2, 256, 128, None), (1, 2, 2, 9, 32, None),
               (1, 4, 1, 9, 32, None), (1, 4, 1, 100, 64, None),
               (2, 4, 2, 130, 32, None)]
FLASH_LARGE = (1, 32, 8, 8192, 64, None)
N_ITER, NU = 32, 1e-6
F32_EPS = 2.0 ** -23


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean ms per call over ``reps`` launches, by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(out[0])
    return out[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.BUILD_INFO
    log(f"[build] sources {[p.name for p in _build.sources()]}")
    log(f"[build] {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["ptxas"].splitlines():
        log(f"[build] {line}")


def phase_kernels(dev):
    import torch
    from repro_torch.kernels.pairwise_dist import gram, gram_plain
    from repro_torch.kernels.rfa import (weighted_sum, weighted_sum_plain,
                                         weiszfeld_plain, weiszfeld_weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    for shape in MAIN_SHAPES + [LARGE_SHAPE]:
        bt, k, d = shape
        large = shape == LARGE_SHAPE
        reps = 5 if large else 200
        x = torch.randn(shape, generator=gen, device=dev) + 1.5

        # gram: each thread sums up to d/256 products in sequence, the
        # plain version sums pairwise: f32 error relative to max|G|
        g = gram(x)
        g_plain = gram_plain(x)
        scale = g_plain.abs().max().item()
        err = (g - g_plain).abs().max().item()
        tol = 2e-5 * scale
        if not torch.equal(g, gram(x)):
            raise AssertionError(f"gram {shape}: rerun is not bit-identical")
        if not err <= tol:
            raise AssertionError(f"gram {shape}: max abs err {err} > {tol}")
        b = bound(4 * (bt * k * d + bt * k * k), 2 * bt * k * k * d)
        xt = x.transpose(1, 2)
        rows[("gram", shape)] = dict(
            err=err, rel=err / scale, tol=tol, large=large,
            ms=time_ms(lambda: gram(x), reps),
            plain_ms=time_ms(lambda: gram_plain(x), max(reps // 10, 2), 1),
            library_ms=time_ms(lambda: torch.bmm(x, xt), reps),
            bound_ms=b[0], bound_by=b[1])

        # weiszfeld on the kernel's Gram matrices: weights lie in [0, 1]
        w = weiszfeld_weights(g, NU, N_ITER)
        w_plain = weiszfeld_plain(g, NU, N_ITER)
        err = (w - w_plain).abs().max().item()
        tol = 1e-5
        if not err <= tol:
            raise AssertionError(f"weiszfeld {shape}: max abs err {err} > "
                                 f"{tol}")
        b = bound(4 * (bt * k * k + bt * k), N_ITER * bt * (2 * k * k + 8 * k))
        rows[("weiszfeld", shape)] = dict(
            err=err, rel=err, tol=tol, large=large,
            ms=time_ms(lambda: weiszfeld_weights(g, NU, N_ITER), reps),
            plain_ms=time_ms(lambda: weiszfeld_plain(g, NU, N_ITER),
                             max(reps // 10, 2), 1),
            library_ms=None, bound_ms=b[0], bound_by=b[1])

        # wsum: one fused multiply-add chain per coordinate
        z = weighted_sum(x, w)
        z_plain = weighted_sum_plain(x, w)
        scale = x.abs().max().item()
        err = (z - z_plain).abs().max().item()
        tol = 1e-5 * scale
        if not err <= tol:
            raise AssertionError(f"wsum {shape}: max abs err {err} > {tol}")
        b = bound(4 * (bt * k * d + bt * k + bt * d), 2 * bt * k * d)
        wv = w[:, None, :]
        rows[("wsum", shape)] = dict(
            err=err, rel=err / scale, tol=tol, large=large,
            ms=time_ms(lambda: weighted_sum(x, w), reps),
            plain_ms=time_ms(lambda: weighted_sum_plain(x, w),
                             max(reps // 10, 2), 1),
            library_ms=time_ms(lambda: torch.bmm(wv, x), reps),
            bound_ms=b[0], bound_by=b[1])
        del x, xt, g, g_plain
        torch.cuda.empty_cache()
    return rows


def _library_reduce(recv, mode: str, n_trim: int):
    """The nearest library path to a cw reduce of recv (K, P, d) over P:
    ``torch.sort`` and a slice mean (the plain mean for ``mean``)."""
    import torch
    p = recv.shape[1]
    if mode == "mean":
        return recv.mean(1)
    s = torch.sort(recv, dim=1).values
    lo, hi = ((p - 1) // 2, p // 2 + 1) if mode == "median" \
        else (n_trim, p - n_trim)
    return s[:, lo:hi].mean(1)


def _library_krum(g, n_near: int):
    """Krum scores by ``torch.sort`` of D² and a slice sum."""
    import torch
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * g, 0.0)
    return torch.sort(d2, dim=-1).values[..., 1:n_near + 1].sum(-1)


def phase_cw_kernels(dev):
    """Krum scores, the trimmed mean and the gossip reduces against their
    plain versions. The plain versions sum in the kernels' order, so the
    expected difference is 0; the stated tolerance, P·eps·max|x| for the
    reduces (K·eps·max|score| for Krum), is what another summation order
    could cost. Integer-grid inputs make every sum exact and must match
    bit for bit, which checks the selection and the tie rule exactly."""
    import torch
    from repro_torch.kernels.gossip_reduce import (
        gossip_reduce, gossip_reduce_plain, neighbor_reduce,
        neighbor_reduce_plain)
    from repro_torch.kernels.krum_score import krum_score, krum_score_plain
    from repro_torch.kernels.pairwise_dist import gram
    from repro_torch.kernels.trimmed_mean import (trimmed_mean,
                                                  trimmed_mean_plain)
    from repro_torch.topology import resolve_topology

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def draw(shape, grid=False):
        if grid:
            return torch.randint(-4, 5, shape, generator=gen,
                                 device=dev).float()
        return torch.randn(shape, generator=gen, device=dev)

    def nbr_of(topology):
        return torch.as_tensor(resolve_topology(topology, 13).nbr_idx,
                               dtype=torch.int64, device=dev)

    rows = {}

    def check(name, label, fn, plain, library, args, *, scale, p, grid,
              large, nbytes, ops):
        out = fn(*args)
        ref = plain(*args)
        if not torch.equal(out, fn(*args)):
            raise AssertionError(f"{name} {label}: rerun is not "
                                 f"bit-identical")
        err = (out - ref).abs().max().item()
        tol = 0.0 if grid else p * F32_EPS * scale
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs err {err} > "
                                 f"{tol}")
        lib_err = (library(*args) - out).abs().max().item()
        reps = 5 if large else 200
        b = bound(nbytes, ops)
        rows[(name, label)] = dict(
            err=err, rel=err / max(scale, 1e-30), tol=tol, large=large,
            lib_err=lib_err, ms=time_ms(lambda: fn(*args), reps),
            plain_ms=time_ms(lambda: plain(*args), max(reps // 10, 2), 1),
            library_ms=time_ms(lambda: library(*args), reps),
            bound_ms=b[0], bound_by=b[1])

    # krum_score on the Gram matrices of the main path's stacks: CartPole
    # Krum (n_byz=3, n_near=8), LunarLander Krum (n_byz=0 counts as 1,
    # n_near=10), Krum's buckets at n_byz=1 (5 bucket means per receiver,
    # n_near=2), an integer grid, and 2^20 Gram matrices of 13 agents
    for (bt, k, d), n_near, grid in [((1, 13, 386), 8, False),
                                     ((1, 13, 4868), 10, False),
                                     ((13, 5, 386), 2, False),
                                     ((1, 13, 386), 8, True)]:
        g = gram(draw((bt, k, d), grid))
        scale = krum_score_plain(g, n_near).abs().max().item()
        check("krum_score", f"x {(bt, k, d)} n_near={n_near}"
              + (" grid" if grid else ""), krum_score, krum_score_plain,
              _library_krum, (g, n_near), scale=scale, p=k, grid=grid,
              large=False, nbytes=4 * (bt * k * k + bt * k),
              ops=bt * k * k * k)
    bt, k = LARGE_CW["krum_bt"], 13
    x = draw((bt, k, 16))
    g = torch.matmul(x, x.transpose(1, 2))       # input only, not timed
    del x
    scale = krum_score_plain(g, 8).abs().max().item()
    check("krum_score", f"G {(bt, k, k)} n_near=8", krum_score,
          krum_score_plain, _library_krum, (g, 8), scale=scale, p=k,
          grid=False, large=True, nbytes=4 * (bt * k * k + bt * k),
          ops=bt * k * k * k)
    del g

    # trimmed_mean over the 13 agents' messages (n_byz=3)
    for (bt, k, d), n_trim, grid, large in [
            ((1, 13, 386), 3, False, False), ((1, 13, 4868), 3, False, False),
            ((1, 13, 386), 3, True, False),
            ((1, 13, LARGE_CW["trimmed_d"]), 3, False, True)]:
        x = draw((bt, k, d), grid)
        check("trimmed_mean", f"{(bt, k, d)} n_trim={n_trim}"
              + (" grid" if grid else ""), trimmed_mean, trimmed_mean_plain,
              lambda x, nt: _library_reduce(x, "trimmed", nt), (x, n_trim),
              scale=x.abs().max().item(), p=k, grid=grid, large=large,
              nbytes=4 * (bt * k * d + bt * d), ops=bt * d * k * k)
        del x

    # the gossip reduces on the complete graph (P=13) and ring(k=4) (P=5)
    modes = {13: [("mean", 0), ("median", 0), ("trimmed", 3)],
             5: [("mean", 0), ("median", 0), ("trimmed", 2)]}
    cases = [("complete", 386, False, False), ("ring(k=4)", 386, False, False),
             ("complete", 4868, False, False), ("complete", 386, True, False)]
    for topology, d, grid, large in cases + [
            ("complete", LARGE_CW["gossip_d"], False, True)]:
        nbr = nbr_of(topology)
        k, p = nbr.shape
        msgs = draw((k, d), grid)
        for mode, n_trim in modes[p]:
            if large and mode != "trimmed":
                continue
            ops = k * d * (p if mode == "mean" else p * p)
            tag = (f"P={p} {mode}" + (f" n_trim={n_trim}" if n_trim else "")
                   + (" grid" if grid else ""))
            check("gossip_reduce", f"{(k, d)} {tag}", gossip_reduce,
                  gossip_reduce_plain,
                  lambda m, nb, md, nt: _library_reduce(m[nb], md, nt),
                  (msgs, nbr, mode, n_trim), scale=msgs.abs().max().item(),
                  p=p, grid=grid, large=large,
                  nbytes=4 * 2 * k * d + 8 * k * p, ops=ops)
        del msgs
    for topology, d, grid, large in cases + [
            ("complete", LARGE_CW["neighbor_d"], False, True)]:
        k, p = nbr_of(topology).shape
        recv = draw((k, p, d), grid)
        for mode, n_trim in modes[p]:
            if large and mode != "median":
                continue
            ops = k * d * (p if mode == "mean" else p * p)
            tag = (f"{mode}" + (f" n_trim={n_trim}" if n_trim else "")
                   + (" grid" if grid else ""))
            check("neighbor_reduce", f"{(k, p, d)} {tag}", neighbor_reduce,
                  neighbor_reduce_plain, _library_reduce,
                  (recv, mode, n_trim), scale=recv.abs().max().item(),
                  p=p, grid=grid, large=large,
                  nbytes=4 * (k * p * d + k * d), ops=ops)
        del recv
        torch.cuda.empty_cache()
    return rows


def _flash_pairs(S: int, window) -> int:
    """Unmasked (query, key) pairs of one head's causal attention."""
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def phase_flash(dev):
    """The flash-attention kernel against its plain version. Both sum in
    f32 in other orders (FMA chains against matmul blockings), so the
    stated tolerance is 2e-5·max|v|, the reference's own for its f32
    kernel tests; reruns must be bit-identical. SDPA (f32, GQA, causal,
    a boolean mask for the windows) is timed as the yardstick and its
    distance from the kernel reported; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import (
        KERNEL_HEAD_DIMS, kernel_shared_bytes)
    log(f"[flash] dynamic shared memory per block: "
        f"{ {hd: kernel_shared_bytes(hd) for hd in KERNEL_HEAD_DIMS} } "
        f"bytes (registers and spills: the build's ptxas lines)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = {}
    for case in FLASH_CASES + [FLASH_LARGE]:
        B, H, Hkv, S, hd, window = case
        large = case == FLASH_LARGE
        q = torch.randn((B * H, S, hd), generator=gen, device=dev)
        k = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        v = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        out = flash_attention_kernel(q, k, v, H, window)
        if not torch.equal(out, flash_attention_kernel(q, k, v, H, window)):
            raise AssertionError(f"flash_attention {case}: rerun is not "
                                 f"bit-identical")
        ref = flash_attention_plain(q, k, v, H, window)
        scale = v.abs().max().item()
        err = (out - ref).abs().max().item()
        tol = 2e-5 * scale
        if not err <= tol:
            raise AssertionError(f"flash_attention {case}: max abs err "
                                 f"{err} > {tol}")
        q4 = q.reshape(B, H, S, hd)
        k4 = k.reshape(B, Hkv, S, hd)
        v4 = v.reshape(B, Hkv, S, hd)
        if window is None:
            def sdpa():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) \
                & ((pos[:, None] - pos[None, :]) < window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=True)
        lib_err = (sdpa().reshape(B * H, S, hd) - out).abs().max().item()
        pairs = B * H * _flash_pairs(S, window)
        b = bound(4 * (2 * B * H * S * hd + 2 * B * Hkv * S * hd),
                  4 * hd * pairs)
        reps = 5 if large else 100
        label = f"q {tuple(q.shape)} kv {tuple(k.shape)}" + (
            f" window={window}" if window is not None else "")
        rows[("flash_attention", label)] = dict(
            err=err, rel=err / scale, tol=tol, large=large, lib_err=lib_err,
            ms=time_ms(lambda: flash_attention_kernel(q, k, v, H, window),
                       reps),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, H,
                                                           window),
                             2 if large else 10, 1),
            library_ms=time_ms(sdpa, reps), bound_ms=b[0], bound_by=b[1])
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return rows


def log_kernel_rows(rows):
    log("[kernels] name            input                                   "
        "max_abs_err  max_rel_err  tol          ms         plain_ms   "
        "library_ms bound_ms  bound_by   library_vs_kernel")
    for (name, shape), r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
        lib_err = f"{r['lib_err']:.3e}" if "lib_err" in r else "-"
        log(f"[kernels] {name:15s} {str(shape):39s} {r['err']:.3e}    "
            f"{r['rel']:.3e}    {r['tol']:.3e}    {r['ms']:.6f}   "
            f"{r['plain_ms']:.6f}   {lib:10s} {r['bound_ms']:.6f}  "
            f"{r['bound_by']:10s} {lib_err}")


def main_runs():
    """(label, env, T, config, launches per iteration) of phase 4."""
    from repro_torch.core.decbyzpg import DecByzPGConfig
    from repro_torch.rl.envs import make_cartpole, make_lunarlander
    cartpole, lunar = make_cartpole(horizon=200), make_lunarlander()
    byz = dict(n_byz=3, attack="large_noise(sigma=10)")
    wide = dict(hidden=(64, 64), activation="tanh")
    rfa_mda = {"gram": 8, "weiszfeld": 1, "wsum": 1}   # 6 MDA, RFA, Δ₂
    krum_cw = {"gram": 2, "krum_score": 1, "gossip_reduce": 6}
    return [
        ("cartpole", cartpole, 8, DecByzPGConfig(**byz), rfa_mda),
        ("lunarlander", lunar, 3, DecByzPGConfig(**wide), rfa_mda),
        ("cartpole_krum_cwtm", cartpole, 8,
         DecByzPGConfig(**byz, aggregator="krum", agreement="cwtm"),
         krum_cw),
        ("cartpole_tm_cwmed_per_receiver", cartpole, 8,
         DecByzPGConfig(**byz, aggregator="trimmed_mean", agreement="cwmed",
                        per_receiver=True),
         {"gram": 1, "trimmed_mean": 1, "neighbor_reduce": 6}),
        ("lunarlander_krum_cwmean", lunar, 3,
         DecByzPGConfig(**wide, aggregator="krum", agreement="cwmean"),
         krum_cw),
    ]


def phase_main_path(dev):
    """Drive ``run_decbyzpg`` as a user would, counting launches: each run
    must launch exactly the kernels of its row. Returns the launches per
    kernel over the runs."""
    import numpy as np
    import torch
    from repro_torch.core.decbyzpg import run_decbyzpg
    from repro_torch.kernels import dispatch

    totals = {}
    for label, env, T, cfg, per_iter in main_runs():
        run_decbyzpg(env, cfg, 1, device=dev)           # warm iteration
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        out = run_decbyzpg(env, cfg, T, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        d = out["theta"].shape[1]
        if not (np.isfinite(out["returns"]).all()
                and np.isfinite(out["diameter"]).all()
                and bool(torch.isfinite(out["theta"]).all())):
            raise AssertionError(f"{label}: non-finite returns, diameter "
                                 f"or theta")
        if out["returns"].shape != (T,) or out["theta"].shape != (cfg.K, d):
            raise AssertionError(f"{label}: unexpected output shapes")
        if not bool(out["coins"][0]):
            raise AssertionError(f"{label}: coin at t=0 is not 1")
        want = {name: per_iter.get(name, 0) * T for name in counts}
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want}")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        log(f"[main] {label}: d={d} T={T} ms/iter={secs / T * 1e3:.3f} "
            f"launches/iter={per_iter} returns={out['returns'].tolist()} "
            f"diameter={out['diameter'].tolist()} "
            f"coins={out['coins'].astype(int).tolist()}")
    return totals


def serving_runs():
    """(label, model config, engine kwargs, requests, prompt lengths,
    flash launches) of phase 5; the config is None for the run through
    ``serve()`` with its defaults (the transformer policy on
    ``cartpole(horizon=32)``, 16 new tokens, prompts of 8 at most)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serving import default_buckets
    qwen_4l = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=4)
    return [
        ("llama3.2-1b_serve", get_config("llama3.2-1b"),
         dict(slots=8, max_prompt=512, max_new=32), 24, (1, 16, 128, 512),
         16 * (len(default_buckets(512)) + 24)),
        ("qwen2.5-3b_4l_serve", qwen_4l,
         dict(slots=4, max_prompt=256, max_new=16), 8, (1, 16, 128, 256),
         4 * (len(default_buckets(256)) + 8)),
        ("policy_serve", None, dict(slots=4, max_new=16), 16, None,
         2 * (len(default_buckets(8)) + 16)),
    ]


class _PhaseTimes:
    """Host ms of every prefill (by bucket, the warmup's left out) and tick
    of the engines built while it is active: it wraps ``DecodeEngine``'s
    two methods, each of which ends in a device-to-host copy, so the host
    clock covers the device work."""

    def __init__(self):
        from repro_torch.serving import engine
        self.cls = engine.DecodeEngine
        self.prefill, self.tick = {}, []

    def __enter__(self):
        cls, times = self.cls, self
        self.orig = (cls.prefill_request, cls.tick)
        orig_prefill, orig_tick = self.orig

        def prefill_request(eng, req):
            t0 = time.perf_counter()
            out = orig_prefill(eng, req)
            if req.uid < 0:                     # the engine's warmup
                return out
            bucket = eng.bucket_for(len(req.tokens) if req.tokens is not None
                                    else 1)
            times.prefill.setdefault(bucket, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

        def tick(eng, state):
            t0 = time.perf_counter()
            out = orig_tick(eng, state)
            times.tick.append((time.perf_counter() - t0) * 1e3)
            return out

        cls.prefill_request, cls.tick = prefill_request, tick
        return self

    def __exit__(self, *exc):
        self.cls.prefill_request, self.cls.tick = self.orig

    def reset(self):
        self.prefill, self.tick = {}, []

    def summary(self) -> str:
        by_bucket = {b: round(sum(t) / len(t), 3)
                     for b, t in sorted(self.prefill.items())}
        per_tick = sum(self.tick) / max(len(self.tick), 1)
        return (f"ticks={len(self.tick)} ms/tick={per_tick:.3f} "
                f"ms/prefill by bucket={by_bucket}")


def _check_served(label, report, traffic, vocab):
    budgets = {r.uid: r.max_new for r in traffic}
    if sorted(r.uid for r in report.results) != sorted(budgets):
        raise AssertionError(f"{label}: served {report.n_requests} of "
                             f"{len(budgets)} requests")
    for r in report.results:
        if len(r.tokens) != budgets[r.uid]:
            raise AssertionError(f"{label}: request {r.uid} got "
                                 f"{len(r.tokens)} tokens, budget "
                                 f"{budgets[r.uid]}")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"{label}: request {r.uid} has tokens "
                                 f"outside [0, {vocab})")


def phase_serving(dev):
    """Serve through the port's front doors, counting launches: flash
    attention must launch once per layer for every prefill, the engine's
    warmup (one prefill per bucket) included, and nothing else may
    launch. Returns the launches per kernel over the runs."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    from repro_torch.serving import (DecodeEngine, PolicyServer,
                                     make_traffic, serve)

    totals = {}
    with _PhaseTimes() as times:
        for label, cfg, kw, n, lens, want_flash in serving_runs():
            torch.cuda.synchronize()
            dispatch.reset_launches()
            times.reset()
            extra = ""
            if cfg is None:
                # cartpole's observations have 4 entries and 2 actions
                report = serve(key=0, n_requests=n, realtime=False,
                               device=dev, **kw)
                traffic = make_traffic(n, seed=0, rate_rps=50.0,
                                       max_new=kw["max_new"], obs_dim=4)
                _check_served(label, report, traffic, 2)
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(0)
                engine = DecodeEngine(cfg, init_params(cfg, gen, device=dev),
                                      device=dev, **kw)
                t0 = time.perf_counter()
                server = PolicyServer(engine)           # runs the warmup
                extra = f" warmup_s={time.perf_counter() - t0:.3f}"
                times.reset()
                traffic = make_traffic(n, seed=0, vocab=cfg.vocab_size,
                                       prompt_lens=lens,
                                       max_new=kw["max_new"])
                report = server.run_offline(traffic)
                _check_served(label, report, traffic, cfg.vocab_size)
            torch.cuda.synchronize()
            counts = dispatch.launch_counts()
            want = {name: 0 for name in counts}
            want["flash_attention"] = want_flash
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}, "
                                     f"expected {want}")
            for name, c in counts.items():
                totals[name] = totals.get(name, 0) + c
            log(f"[serve] {label}: {report.summary()} {times.summary()}"
                f"{extra} flash_launches={counts['flash_attention']}")
            log(f"[serve] {label}: first streams "
                f"{[r.tokens[:8] for r in report.results[:3]]}")
            del report
            torch.cuda.empty_cache()
    return totals


def phase_serving_cpu_agreement(dev):
    """Llama-3.2-1B's width at 2 layers (depth cut only), the same weights
    on the card and on the CPU: prefill logits within 1e-4 (f32 sums in
    other orders over d_model 2048 and d_ff 8192, logits of O(1)), and
    the served greedy streams equal up to each request's first step whose
    top-1 margin (on the CPU) is within that tolerance."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import (decode_step, init_params, prefill,
                                          tree_map)
    from repro_torch.serving import (DecodeEngine, PolicyServer,
                                     make_traffic)
    tol = 1e-4
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    gen = torch.Generator()
    gen.manual_seed(1)
    cpu_params = init_params(cfg, gen, device="cpu")
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    traffic = make_traffic(4, seed=1, vocab=cfg.vocab_size,
                           prompt_lens=(1, 16, 77, 128), max_new=8,
                           jitter_budget=False)
    worst = 0.0
    for req in traffic:
        toks = torch.as_tensor(req.tokens[None], dtype=torch.long)
        lc, _ = prefill(cfg, cpu_params, toks, last_only=False)
        lg, _ = prefill(cfg, card_params, toks.to(dev), last_only=False)
        err = (lg.cpu() - lc).abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"card/CPU prefill logits of request "
                                 f"{req.uid} differ by {err} > {tol}")
    streams = {}
    for d, params in (("cpu", cpu_params), (dev, card_params)):
        engine = DecodeEngine(cfg, params, slots=4, max_new=8,
                              max_prompt=128, device=d)
        report = PolicyServer(engine, warmup=False).run_offline(traffic)
        streams[str(d)] = {r.uid: r.tokens for r in report.results}
    compared = 0
    for req in traffic:
        # the CPU's unbatched greedy stream and each step's top-1 margin
        W = len(req.tokens) + req.max_new
        logits, cache = prefill(cfg, cpu_params, torch.as_tensor(
            req.tokens[None], dtype=torch.long), cache_len=W)
        row, margins, want = logits[0, -1], [], []
        for i in range(req.max_new):
            top = torch.topk(row, 2).values
            margins.append((top[0] - top[1]).item())
            tok = torch.argmax(row)
            want.append(int(tok))
            if i + 1 < req.max_new:
                logits, cache = decode_step(cfg, cpu_params, tok[None],
                                            cache)
                row = logits[0, 0]
        n = next((i for i, m in enumerate(margins) if m <= tol),
                 len(margins))
        cpu_s, card_s = streams["cpu"][req.uid], streams[str(dev)][req.uid]
        if cpu_s != want or card_s[:n] != want[:n] \
                or len(card_s) != len(want):
            raise AssertionError(f"request {req.uid}: card {card_s}, CPU "
                                 f"{cpu_s}, unbatched {want}, margins "
                                 f"{margins}")
        compared += n
    log(f"[check] card vs CPU, Llama-3.2-1B width at 2 layers (4 requests, "
        f"prompts <= 128, 8 new tokens): prefill logits max abs err "
        f"{worst:.3e} (tol {tol}); streams equal over {compared} of "
        f"{sum(r.max_new for r in traffic)} tokens under the margin rule")


def phase_cpu_agreement(dev):
    """Small runs on the card against the same runs on the CPU (plain
    versions), fed the same draws and θ₀: RFA/MDA, Krum/cwtm and the
    trimmed mean with cwmed under per-receiver equivocation."""
    import numpy as np
    import torch
    from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
    from repro_torch.core.noise import draw_step_noise
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.policy import resolve_policy

    env = make_cartpole(horizon=32)
    small = dict(K=13, n_byz=3, attack="large_noise(sigma=10)", N=8, B=2)
    T = 3
    for label, cfg in [
            ("rfa_mda", DecByzPGConfig(**small)),
            ("krum_cwtm", DecByzPGConfig(**small, aggregator="krum",
                                         agreement="cwtm")),
            ("tm_cwmed_per_receiver",
             DecByzPGConfig(**small, aggregator="trimmed_mean",
                            agreement="cwmed", per_receiver=True))]:
        policy = resolve_policy(cfg, env)
        gen = torch.Generator()
        gen.manual_seed(1)
        theta0 = policy.init(gen)
        noise = [draw_step_noise(gen, cfg, env, policy.d, t)
                 for t in range(T)]
        on_card = [type(nz)(*(None if x is None else x.to(dev) for x in nz))
                   for nz in noise]
        cpu = run_decbyzpg(env, cfg, T, device="cpu", theta0=theta0,
                           noise=noise)
        gpu = run_decbyzpg(env, cfg, T, device=dev, theta0=theta0.to(dev),
                           noise=on_card)
        # f32 sums in other orders on the two devices; the rollouts must
        # pick the same actions, so returns agree to rounding
        if not np.array_equal(cpu["coins"], gpu["coins"]):
            raise AssertionError(f"{label}: card/CPU coins differ")
        np.testing.assert_allclose(gpu["returns"], cpu["returns"], rtol=1e-5)
        th_err = (gpu["theta"].cpu() - cpu["theta"]).abs().max().item()
        if not th_err <= 1e-4:
            raise AssertionError(f"{label}: card/CPU theta differ by "
                                 f"{th_err} > 1e-4")
        log(f"[check] card vs CPU plain path, {label} (K=13, n_byz=3, "
            f"T={T}): coins equal, returns within rtol 1e-5, theta max abs "
            f"err {th_err:.3e} (tol 1e-4)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phase_card()
    phase_build()
    rows = phase_kernels(dev)
    rows.update(phase_cw_kernels(dev))
    rows.update(phase_flash(dev))
    log_kernel_rows(rows)
    totals = phase_main_path(dev)
    phase_cpu_agreement(dev)
    for name, n in phase_serving(dev).items():
        totals[name] = totals.get(name, 0) + n
    phase_serving_cpu_agreement(dev)
    from repro_torch.kernels import dispatch
    missing = [name for name in dispatch.kernels()
               if totals.get(name, 0) <= 0]
    if missing or set(dispatch.kernels()) != set(REPLACES):
        raise AssertionError(f"kernels never launched on a path: {missing}; "
                             f"registered {sorted(dispatch.kernels())}")
    for m in ("jax", "repro"):
        if m in sys.modules:
            raise AssertionError(f"{m} was imported")
    kernels = []
    for name in REPLACES:
        head = rows[(name, HEADLINE[name])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, SOURCE),
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": max(r["err"] for (n, _), r in rows.items()
                               if n == name and not r["large"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
