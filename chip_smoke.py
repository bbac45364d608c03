#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is non-zero):

1. Card: the GPU's name and power limit, as ``nvidia-smi`` reports them.
2. Build: every ``kernels/csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one
   compile per source in parallel, linked into one library.
3. Kernels: ``gram``, ``weiszfeld`` and ``wsum``, then ``krum_score``,
   ``trimmed_mean``, ``gossip_reduce`` and ``neighbor_reduce`` (each mode)
   and ``flash_attention`` against their plain PyTorch versions on the
   card, at the main path's shapes and large inputs (``gram``, ``wsum``:
   three large stacks, ``LARGE_SHAPES``); every kernel is rerun for
   bit-identity, ``gram`` must be exactly symmetric, ``weiszfeld`` must
   match its plain version bit for bit, one integer-grid input per cw
   kernel must match its plain version bit for bit, ``weiszfeld`` and
   ``krum_score`` must at every stack height on the edges of their
   instances (``K_EDGES``, with NaN and infinite entries in G), and
   flash attention must also take strided (B, S, H, hd) tensors, sliced
   out of one fused projection, with the folded launch's bits. Two
   times per kernel and per library yardstick (``torch.bmm``, ``torch.sort``
   plus a slice mean or sum, SDPA; timed only, never called by the port),
   taken in turns (kernel, library, library, kernel), medians of
   ``ROUNDS``: the issue-bound time (``ms``: a Python loop of calls, the
   host's cost of issuing one call for a small kernel) and the device
   time (``device_ms``: the same calls replayed from one CUDA graph), the
   latter at every headline input and every shape of the first three.
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
6. ByzPG (paper Algorithm 1, ``byzpg_runs()``) at its defaults (K=13,
   N=50, B=4, MLP (16, 16) relu): CartPole under ``large_noise`` with
   bucketing ∘ RFA and with Krum for 8 iterations, LunarLander with the
   trimmed mean for 3, each after a warm iteration with exact launches
   per iteration; then small runs on the card against the CPU's plain
   path (bucketed RFA, Krum, trimmed mean).
7. ``Experiment(...).run()``, the front door of the paper's figures
   (``experiment_cells()``): the reference's fig5 cell (ByzPG, attack ×
   aggregator, 3 seeds, T=15) and fig1's DecByzPG K axis with its κ
   override, with exact launches, each scenario's final return ± CI, the
   wall per iteration, and each seed's history bit-equal to its single
   run in the first scenario.
8. Telemetry: three of the runs above at T=4 with ``telemetry=True``
   under an ``obs.MemorySink``: returns, coins, Δ₂ and θ bit-identical
   to the run without it, one tap per iteration, the rejection mask's
   launches counted. Then a checkpoint round trip: ``byzpg_cartpole``'s
   parameters saved and restored onto the card bit for bit, and one
   request served through ``policy_params(checkpoint=)``.
   Phases 6–8 are driven with the launch counts set to 0 just before
   each run and read just after; their launches join the totals.
9. The kernel table as one JSON line (``device_ms`` and
   ``library_device_ms`` beside the issue-bound ``ms`` and
   ``library_ms``), then
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
# large stacks: one model-size stack of 13 agents, 32 agents, and a batch
# of 13 stacks (MDA's receivers) of 2^20 coordinates
LARGE_SHAPES = [(1, 13, 1 << 24), (1, 32, 1 << 22), (13, 13, 1 << 20)]
# the large input of each cw kernel, a few hundred MB: Krum's scoring over
# 2^20 Gram matrices of 13 agents, the trimmed mean of 13 stacks of 2^24,
# the gossip reduces of 13 agents' messages of 2^22 and 2^20 coordinates
LARGE_CW = {"krum_bt": 1 << 20, "trimmed_d": 1 << 24, "gossip_d": 1 << 22,
            "neighbor_d": 1 << 20}
SOURCE = "src/repro_torch/kernels/csrc/aggregation.cu"
SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/attention.cu",
           **dict.fromkeys(("krum_score", "trimmed_mean", "gossip_reduce",
                            "neighbor_reduce"),
                           "src/repro_torch/kernels/csrc/cw_reduce.cu")}
# the slot counts at the edges of the cw rank network's instances (exact 5;
# padded heights 8, 16 and 32), held bit for bit on an integer grid
CW_EDGES = (5, 8, 9, 16, 17, 32)
# the stack heights at the edges of the weiszfeld instances (8, 16, 32)
# and of krum_score's rank network (exact 5 and 13; padded 8, 16, 32),
# held bit for bit
K_EDGES = (1, 4, 5, 7, 8, 9, 13, 16, 17, 24, 32)
# the TPU kernel each replaces: the line of the function that holds the
# kernel's body (its pallas_call is a few lines below it, PERF.md §6)
REPLACES = {
    "gram": "src/repro/kernels/pairwise_dist/pairwise_dist.py:30",
    "weiszfeld": "src/repro/kernels/rfa/rfa.py:33",
    "wsum": "src/repro/kernels/rfa/rfa.py:55",
    "krum_score": "src/repro/kernels/krum_score/krum_score.py:24",
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
# the policy's 9-position prefill (hd 32, G = 1), ragged grouped ones, and
# the 16- and 128-token buckets that Llama's serving prefills most
FLASH_CASES = [(1, 32, 8, 512, 64, None), (1, 32, 8, 512, 64, 1),
               (1, 32, 8, 512, 64, 7), (1, 32, 8, 512, 64, 128),
               (1, 16, 2, 256, 128, None), (1, 2, 2, 9, 32, None),
               (1, 4, 1, 9, 32, None), (1, 4, 1, 100, 64, None),
               (2, 4, 2, 130, 32, None), (1, 32, 8, 16, 64, None),
               (1, 32, 8, 128, 64, None)]
FLASH_LARGE = (1, 32, 8, 8192, 64, None)
# head dims the kernel is not compiled for (run zero-padded to 64 and 128):
# a transformer policy's (d_model 96, 2 heads) and a 96-wide head
FLASH_PADDED = [(1, 2, 2, 9, 48, None), (2, 4, 2, 130, 48, 100),
                (1, 8, 2, 256, 96, None)]
N_ITER, NU = 32, 1e-6
F32_EPS = 2.0 ** -23


def log(msg: str) -> None:
    print(msg, flush=True)


ROUNDS = 5            # repetitions of every paired timing; medians kept


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Issue-bound time: mean ms per call of a Python loop of ``reps``
    calls, by CUDA events. For a small kernel this is the host's cost of
    issuing one call."""
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


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


class GraphTimer:
    """Device time: ``reps`` calls of ``fn`` captured once in a CUDA graph;
    :meth:`ms` replays it and returns ms per call by CUDA events, without
    the host's cost of issuing the calls."""

    def __init__(self, fn, reps: int):
        import torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(reps):
                fn()
        self.reps = reps
        self.graph.replay()
        torch.cuda.synchronize()

    def ms(self) -> float:
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / self.reps


def paired_ms(fn, lib, reps: int, device: bool = True) -> dict:
    """The kernel and its library call timed in turns (kernel, library,
    library, kernel), ``ROUNDS`` times, medians: the issue-bound time
    (``ms``, ``library_ms``) and, when ``device``, the device time by
    graph replay (``device_ms``, ``library_device_ms``). ``lib`` may be
    None; absent numbers are None."""
    out = dict(ms=None, library_ms=None, device_ms=None,
               library_device_ms=None)
    issue = {"k": [], "l": []}
    for _ in range(ROUNDS):
        for who in ("k", "l", "l", "k"):
            if who == "k" or lib is not None:
                issue[who].append(time_ms(fn if who == "k" else lib, reps))
    out["ms"] = _median(issue["k"])
    if lib is not None:
        out["library_ms"] = _median(issue["l"])
    if device:
        timers = {"k": GraphTimer(fn, reps)}
        if lib is not None:
            timers["l"] = GraphTimer(lib, reps)
        dev = {"k": [], "l": []}
        for _ in range(ROUNDS):
            for who in ("k", "l", "l", "k"):
                if who in timers:
                    dev[who].append(timers[who].ms())
        out["device_ms"] = _median(dev["k"])
        if lib is not None:
            out["library_device_ms"] = _median(dev["l"])
        del timers
    return out


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
    """gram, weiszfeld and wsum against their plain versions at the main
    path's shapes and the large stacks, with issue-bound and device times
    beside ``torch.bmm``'s, measured the same way in turns."""
    import torch
    from repro_torch.kernels.pairwise_dist import gram, gram_plain
    from repro_torch.kernels.rfa import (weighted_sum, weighted_sum_plain,
                                         weiszfeld_plain, weiszfeld_weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    for shape in MAIN_SHAPES + LARGE_SHAPES:
        bt, k, d = shape
        large = shape in LARGE_SHAPES
        reps = 5 if large else 200
        x = torch.randn(shape, generator=gen, device=dev) + 1.5

        # gram: the kernel sums each chunk's products per thread, then
        # over threads and chunks in fixed orders; the plain version sums
        # each chunk with PyTorch's reduction: f32 error relative to max|G|
        g = gram(x)
        g_plain = gram_plain(x)
        scale = g_plain.abs().max().item()
        err = (g - g_plain).abs().max().item()
        tol = 2e-5 * scale
        if not torch.equal(g, gram(x)):
            raise AssertionError(f"gram {shape}: rerun is not bit-identical")
        if not torch.equal(g, g.transpose(1, 2)):
            raise AssertionError(f"gram {shape}: G is not exactly "
                                 f"symmetric")
        if not err <= tol:
            raise AssertionError(f"gram {shape}: max abs err {err} > {tol}")
        b = bound(4 * (bt * k * d + bt * k * k), 2 * bt * k * k * d)
        xt = x.transpose(1, 2)
        rows[("gram", shape)] = dict(
            err=err, rel=err / scale, tol=tol, large=large,
            **paired_ms(lambda: gram(x), lambda: torch.bmm(x, xt), reps),
            plain_ms=time_ms(lambda: gram_plain(x), max(reps // 10, 2), 1),
            bound_ms=b[0], bound_by=b[1])

        # weiszfeld on the kernel's Gram matrices: the plain version is the
        # kernel's order of IEEE operations, so the bits must be equal
        w = weiszfeld_weights(g, NU, N_ITER)
        w_plain = weiszfeld_plain(g, NU, N_ITER)
        err = (w - w_plain).abs().max().item()
        tol = 0.0
        if not torch.equal(w, weiszfeld_weights(g, NU, N_ITER)):
            raise AssertionError(f"weiszfeld {shape}: rerun is not "
                                 f"bit-identical")
        if not torch.equal(w, w_plain):
            raise AssertionError(f"weiszfeld {shape}: max abs err {err} > "
                                 f"{tol}")
        b = bound(4 * (bt * k * k + bt * k), N_ITER * bt * (2 * k * k + 8 * k))
        rows[("weiszfeld", shape)] = dict(
            err=err, rel=err, tol=tol, large=large,
            **paired_ms(lambda: weiszfeld_weights(g, NU, N_ITER), None,
                        reps),
            plain_ms=time_ms(lambda: weiszfeld_plain(g, NU, N_ITER),
                             max(reps // 10, 2), 1),
            bound_ms=b[0], bound_by=b[1])

        # wsum: one fused multiply-add chain per coordinate
        z = weighted_sum(x, w)
        z_plain = weighted_sum_plain(x, w)
        scale = x.abs().max().item()
        err = (z - z_plain).abs().max().item()
        tol = 1e-5 * scale
        if not torch.equal(z, weighted_sum(x, w)):
            raise AssertionError(f"wsum {shape}: rerun is not bit-identical")
        if not err <= tol:
            raise AssertionError(f"wsum {shape}: max abs err {err} > {tol}")
        b = bound(4 * (bt * k * d + bt * k + bt * d), 2 * bt * k * d)
        wv = w[:, None, :]
        rows[("wsum", shape)] = dict(
            err=err, rel=err / scale, tol=tol, large=large,
            **paired_ms(lambda: weighted_sum(x, w), lambda: torch.bmm(wv, x),
                        reps),
            plain_ms=time_ms(lambda: weighted_sum_plain(x, w),
                             max(reps // 10, 2), 1),
            bound_ms=b[0], bound_by=b[1])
        del x, xt, g, g_plain, z, z_plain
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
            lib_err=lib_err,
            **paired_ms(lambda: fn(*args), lambda: library(*args), reps,
                        device=large or label == HEADLINE[name]),
            plain_ms=time_ms(lambda: plain(*args), max(reps // 10, 2), 1),
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
    phase_cw_edges(dev, draw)
    phase_k_edges(dev)
    for (name, label), r in rows.items():
        if r["large"]:
            log(f"[large] {name} {label}: device {r['device_ms']:.6f} ms, "
                f"issue {r['ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}, one operation per compare), "
                f"{r['bound_ms'] / r['device_ms']:.1%} of the bound; "
                f"library device {r['library_device_ms']:.6f} ms")
    return rows


def phase_cw_edges(dev, draw):
    """The cw kernels at the slot counts on the edges of their rank
    networks' instances (``CW_EDGES``), on an integer grid with a NaN, a
    +inf and a -inf slot in some coordinates: bit for bit against the
    plain versions (NaN in the same places) in every mode, reruns
    bit-identical. ``gossip_reduce`` gathers from a random (13, P) table,
    ``neighbor_reduce`` reduces (13, P, 386), ``trimmed_mean`` (1, P, 386)
    over P agents."""
    import torch
    from repro_torch.kernels.gossip_reduce import (
        cw_reduce, gossip_reduce, gossip_reduce_plain, neighbor_reduce,
        neighbor_reduce_plain)
    from repro_torch.kernels.trimmed_mean import (trimmed_mean,
                                                  trimmed_mean_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def specials(x):
        x[..., 0, 1] = float("nan")
        x[..., -1, 2] = float("inf")
        x[..., 0, 3] = float("-inf")
        return x

    def same(name, fn, plain, *args):
        out = fn(*args)
        for other in (fn(*args), plain(*args)):
            torch.testing.assert_close(out, other, rtol=0, atol=0,
                                       equal_nan=True, msg=lambda m: (
                                           f"{name} P={p}: {m}"))

    d = 386
    for p in CW_EDGES:
        nbr = torch.randint(0, 13, (13, p), generator=gen, device=dev)
        msgs = specials(draw((13, d), True))
        recv = specials(draw((13, p, d), True))
        for mode, n_trim in (("mean", 0), ("median", 0),
                             ("trimmed", (p - 1) // 2)):
            same("gossip_reduce", gossip_reduce, gossip_reduce_plain, msgs,
                 nbr, mode, n_trim)
            same("neighbor_reduce", neighbor_reduce, neighbor_reduce_plain,
                 recv, mode, n_trim)
        same("trimmed_mean", trimmed_mean, trimmed_mean_plain,
             specials(draw((1, p, d), True)), (p - 1) // 4)
        log(f"[cw] P={p} (rank network height {cw_reduce.cw_instance(p)}): "
            f"gossip_reduce, neighbor_reduce (mean, median, trimmed) and "
            f"trimmed_mean bit-equal to their plain versions on an integer "
            f"grid with NaN and infinite slots, reruns bit-identical")


def phase_k_edges(dev):
    """``weiszfeld`` and ``krum_score`` at the stack heights on the edges of
    their instances (``K_EDGES``), on the Gram matrices of 13 stacks of
    (K, 386): normal rows, a duplicated row, an outlier row, and NaN and
    infinite entries in G. Bit for bit against the plain versions (NaN in
    the same places), weiszfeld at 0, 1 and 32 steps and krum_score at
    three n_near; reruns bit-identical."""
    import torch
    from repro_torch.kernels.gossip_reduce import cw_reduce
    from repro_torch.kernels.krum_score import krum_score, krum_score_plain
    from repro_torch.kernels.pairwise_dist import gram
    from repro_torch.kernels.rfa import (weiszfeld_instance, weiszfeld_plain,
                                         weiszfeld_weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def same(name, fn, plain, *args):
        out = fn(*args)
        for other in (fn(*args), plain(*args)):
            torch.testing.assert_close(out, other, rtol=0, atol=0,
                                       equal_nan=True, msg=lambda m: (
                                           f"{name} K={k} {args[1:]}: {m}"))

    for k in K_EDGES:
        x = torch.randn((13, k, 386), generator=gen, device=dev) + 1.0
        x[1, k - 1] = x[1, 0]                           # a duplicated row
        x[2, k // 2] += 100.0                           # an outlier row
        g = gram(x)
        specials = g.clone()
        specials[3, 0, k - 1] = float("nan")
        specials[4, k - 1, k // 2] = float("inf")
        specials[5, k // 2, k // 2] = float("inf")
        specials[6, 0, k - 1] = specials[6, k - 1, 0] = float("-inf")
        for gg in (g, specials):
            for n_iter in (0, 1, N_ITER):
                same("weiszfeld", weiszfeld_weights, weiszfeld_plain, gg, NU,
                     n_iter)
            for n_near in sorted({1, max(k // 2, 1), max(k - 1, 1)}):
                same("krum_score", krum_score, krum_score_plain, gg, n_near)
        log(f"[edges] K={k} (weiszfeld height {weiszfeld_instance(k)}, "
            f"krum_score rank network height {cw_reduce.cw_instance(k)}): "
            f"both bit-equal to their plain versions on normal, duplicated "
            f"and outlier rows and on G with NaN and infinite entries, "
            f"reruns bit-identical")


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
            **paired_ms(lambda: flash_attention_kernel(q, k, v, H, window),
                        sdpa, reps,
                        device=label == HEADLINE["flash_attention"]),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, H,
                                                           window),
                             2 if large else 10, 1),
            bound_ms=b[0], bound_by=b[1])
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    phase_flash_layout(dev)
    phase_flash_padded(dev)
    return rows


def phase_flash_padded(dev):
    """Head dims the kernel is not compiled for (``FLASH_PADDED``): the
    wrapper zero-pads q, k and v to the next compiled head dim and passes
    the true scale. Each must launch the kernel (never the plain version),
    agree with the plain version at the true head dim (2e-5·max|v|),
    rerun bit-identically, and give the folded launch's bits through the
    model layout."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_head_dim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for B, H, Hkv, S, hd, window in FLASH_PADDED:
        q = torch.randn((B * H, S, hd), generator=gen, device=dev)
        k = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        v = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        before = dispatch.launch_counts()["flash_attention"]
        out = flash_attention_kernel(q, k, v, H, window)
        rerun = flash_attention_kernel(q, k, v, H, window)
        layout = flash_attention(*(x.reshape(B, -1, S, hd).transpose(1, 2)
                                   for x in (q, k, v)), window)
        torch.cuda.synchronize()
        launched = dispatch.launch_counts()["flash_attention"] - before
        err = (out - flash_attention_plain(q, k, v, H, window)).abs().max()
        tol = 2e-5 * v.abs().max().item()
        unfold = out.reshape(B, H, S, hd).transpose(1, 2)
        if not (launched == 3 and err.item() <= tol
                and torch.equal(out, rerun) and torch.equal(layout, unfold)):
            raise AssertionError(
                f"flash_attention at head dim {hd} {(B, H, Hkv, S, window)}: "
                f"{launched} launches of 3, max abs err {err.item()} (tol "
                f"{tol}), rerun equal {torch.equal(out, rerun)}, layout "
                f"equal {torch.equal(layout, unfold)}")
        ms = time_ms(lambda: flash_attention_kernel(q, k, v, H, window), 50)
        log(f"[flash] head dim {hd} on the hd {kernel_head_dim(hd)} kernel, "
            f"q {tuple(q.shape)} kv {tuple(k.shape)} window {window}: max "
            f"abs err {err.item():.3e} against the plain version (tol "
            f"{tol:.3e}), rerun and model layout bit-equal, issue-bound "
            f"{ms:.6f} ms")


def phase_flash_layout(dev):
    """The model-layout launch on strided tensors, as the serving path
    hands them over: q, k and v sliced out of one fused (B, S, H + 2·Hkv,
    hd) tensor at Llama-3.2-1B's and Qwen2.5-3B's widths, against the
    plain version on contiguous folded copies (tolerance 2e-5·max|v|) and
    against the folded launch on those copies (the same bits)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for case in [(1, 32, 8, 512, 64, None), (2, 32, 8, 130, 64, 100),
                 (1, 16, 2, 256, 128, None)]:
        B, H, Hkv, S, hd, window = case
        fused = torch.randn((B, S, H + 2 * Hkv, hd), generator=gen,
                            device=dev)
        q, k, v = (fused[:, :, :H], fused[:, :, H:H + Hkv],
                   fused[:, :, H + Hkv:])
        out = flash_attention_kernel(q, k, v, window=window)
        fold = [x.transpose(1, 2).reshape(B * x.shape[2], S, hd).contiguous()
                for x in (q, k, v)]
        ref = flash_attention_plain(*fold, H, window)
        folded = flash_attention_kernel(*fold, H, window)
        unfold = folded.reshape(B, H, S, hd).transpose(1, 2)
        err = (out - ref.reshape(B, H, S, hd).transpose(1, 2)).abs().max()
        tol = 2e-5 * v.abs().max().item()
        if not err.item() <= tol or not torch.equal(out, unfold):
            raise AssertionError(f"flash_attention model layout {case}: "
                                 f"max abs err {err.item()} (tol {tol}), "
                                 f"equal to the folded launch: "
                                 f"{torch.equal(out, unfold)}")
        log(f"[flash] strided (B, S, H, hd) q {tuple(q.shape)} strides "
            f"{q.stride()}, window {window}: max abs err {err.item():.3e} "
            f"against the plain version (tol {tol:.3e}), bits equal to the "
            f"folded launch")


def log_kernel_rows(rows):
    def num(v):
        return "null" if v is None else f"{v:.6f}"
    log("[kernels] name            input                                   "
        "max_abs_err  max_rel_err  tol          ms         device_ms  "
        "plain_ms   library_ms lib_dev_ms bound_ms  bound_by   "
        "library_vs_kernel")
    for (name, shape), r in rows.items():
        lib_err = f"{r['lib_err']:.3e}" if "lib_err" in r else "-"
        log(f"[kernels] {name:15s} {str(shape):39s} {r['err']:.3e}    "
            f"{r['rel']:.3e}    {r['tol']:.3e}    {num(r['ms']):10s} "
            f"{num(r['device_ms']):10s} {num(r['plain_ms']):10s} "
            f"{num(r['library_ms']):10s} {num(r['library_device_ms']):10s} "
            f"{r['bound_ms']:.6f}  {r['bound_by']:10s} {lib_err}")
    for shape in LARGE_SHAPES:
        for name in ("gram", "wsum"):
            r = rows[(name, shape)]
            log(f"[large] {name} {shape}: device {r['device_ms']:.6f} ms, "
                f"issue {r['ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {r['bound_ms'] / r['device_ms']:.1%} "
                f"of the bound; torch.bmm device "
                f"{r['library_device_ms']:.6f} ms")


def _check_launches(label, counts, want):
    want = {name: want.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def _add(totals, counts):
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n


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
        _check_launches(label, counts,
                        {k: n * T for k, n in per_iter.items()})
        _add(totals, counts)
        log(f"[main] {label}: d={d} T={T} ms/iter={secs / T * 1e3:.3f} "
            f"launches/iter={per_iter} returns={out['returns'].tolist()} "
            f"diameter={out['diameter'].tolist()} "
            f"coins={out['coins'].astype(int).tolist()}")
    return totals


def byzpg_runs():
    """(label, env, T, config, launches per iteration) of the ByzPG phase:
    the paper's Algorithm 1 at its defaults (K=13, N=50, B=4, MLP (16, 16)
    relu). The server aggregates on every iteration: bucketing (7 buckets
    of 2) ∘ RFA on (1, 7, d), Krum on (1, 13, d), the trimmed mean on
    (1, 13, d); no agreement, no diameter."""
    from repro_torch.core.byzpg import ByzPGConfig
    from repro_torch.rl.envs import make_cartpole, make_lunarlander
    cartpole = make_cartpole(horizon=200)
    byz = dict(n_byz=3, attack="large_noise(sigma=10)")
    return [
        ("byzpg_cartpole", cartpole, 8, ByzPGConfig(**byz),
         {"gram": 1, "weiszfeld": 1, "wsum": 1}),
        ("byzpg_cartpole_krum", cartpole, 8,
         ByzPGConfig(**byz, aggregator="krum"),
         {"gram": 1, "krum_score": 1}),
        ("byzpg_lunarlander_tm", make_lunarlander(), 3,
         ByzPGConfig(hidden=(64, 64), activation="tanh", n_byz=3,
                     aggregator="trimmed_mean"),
         {"trimmed_mean": 1}),
    ]


def phase_byzpg(dev):
    """Drive ``run_byzpg`` as a user would, counting launches: each run
    must launch exactly the kernels of its row. Returns the launches per
    kernel over the runs and the ``byzpg_cartpole`` output."""
    import numpy as np
    import torch
    from repro_torch.core.byzpg import run_byzpg
    from repro_torch.kernels import dispatch

    totals, kept = {}, None
    for label, env, T, cfg, per_iter in byzpg_runs():
        run_byzpg(env, cfg, 1, device=dev)              # warm iteration
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        out = run_byzpg(env, cfg, T, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        d = out["vec"].shape[0]
        if not (np.isfinite(out["returns"]).all()
                and bool(torch.isfinite(out["vec"]).all())):
            raise AssertionError(f"{label}: non-finite returns or theta")
        if out["returns"].shape != (T,) or out["vec"].device.type != dev.type:
            raise AssertionError(f"{label}: unexpected output shapes")
        if not bool(out["coins"][0]):
            raise AssertionError(f"{label}: coin at t=0 is not 1")
        _check_launches(label, counts,
                        {k: n * T for k, n in per_iter.items()})
        _add(totals, counts)
        log(f"[byzpg] {label}: d={d} T={T} ms/iter={secs / T * 1e3:.3f} "
            f"launches/iter={per_iter} returns={out['returns'].tolist()} "
            f"coins={out['coins'].astype(int).tolist()}")
        if label == "byzpg_cartpole":
            kept = out
    return totals, kept


#: the reference's fig5 cell (benchmarks/run.py): ByzPG under two attacks
#: against RFA and the plain mean (Fed-PAGE-PG), and fig1's DecByzPG K axis
#: with its κ override
FIG_T, FIG_SEEDS = 15, (0, 1, 2)
FIG_BASE = dict(env="cartpole(horizon=100)", T=FIG_T, seeds=FIG_SEEDS, N=20,
                B=4, eta=2e-2)


def _fig1_kappa(c):
    import dataclasses
    return dataclasses.replace(c, kappa=4 if c.K > 1 else 0)


def experiment_cells():
    """(label, Experiment kwargs, launches per iteration of one seed by
    scenario); a scenario absent from the map launches nothing."""
    return [
        ("fig5_byzpg", dict(FIG_BASE, algo="byzpg", axes={
            "attack": ("large_noise", "avg_zero"),
            "aggregator": ("rfa", "mean")}, K=13, n_byz=3),
         lambda scn: ({"gram": 1, "weiszfeld": 1, "wsum": 1}
                      if scn.aggregator == "rfa" else {})),
        # n_byz 0: RFA unbucketed on (1, K, d), κ MDA grams and Δ₂'s gram
        ("fig1_decbyzpg", dict(FIG_BASE, algo="decbyzpg",
                               axes={"K": (1, 5, 13)},
                               override=_fig1_kappa),
         lambda scn: {"gram": 2 + (4 if scn.K > 1 else 0), "weiszfeld": 1,
                      "wsum": 1}),
    ]


def phase_experiment(dev):
    """The paper's figure front door, ``Experiment(...).run()``: every
    scenario's (3, 15) seed histories, mean ± CI of the final return, wall
    per iteration, exact launches, and each seed's history bit-equal to
    the single run for that seed in the first scenario. Returns the
    launches per kernel of the Experiment runs (the checks' single runs
    left out)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import Experiment
    from repro_torch.core.engine import ScenarioGrid, grid_scenarios
    from repro_torch.core.registry import resolve
    from repro_torch.kernels import dispatch

    totals = {}
    for label, kw, per_iter in experiment_cells():
        exp = Experiment(device=dev, **kw)
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        res = exp.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        S = len(FIG_SEEDS)
        n_scn = int(np.prod([len(v) for v in kw["axes"].values()]))
        want = {}
        for scn in res:
            _add(want, {k: n * S * FIG_T for k, n in per_iter(scn).items()})
        if len(res) != n_scn:
            raise AssertionError(f"{label}: {len(res)} scenarios, expected "
                                 f"{n_scn}")
        _check_launches(label, counts, want)
        _add(totals, counts)
        for scn, out in res.items():
            if out["returns"].shape != (S, FIG_T) \
                    or not np.isfinite(out["returns"]).all():
                raise AssertionError(f"{label} {scn}: returns of shape "
                                     f"{out['returns'].shape}, or not finite")
            log(f"[experiment] {label} {res.scenario_name(scn)}: final "
                f"return {out['final_return_mean']:.3f} ± "
                f"{out['final_return_ci95']:.3f} (95% CI, {S} seeds)")
        log(f"[experiment] {label}: {n_scn} scenarios x {S} seeds x T="
            f"{FIG_T} in {secs:.3f} s: {secs / FIG_T * 1e3:.3f} ms per "
            f"iteration of the whole grid, {secs / (n_scn * FIG_T) * 1e3:.3f}"
            f" ms per iteration of one scenario's seed batch, "
            f"{secs / (n_scn * S * FIG_T) * 1e3:.3f} ms per single-run "
            f"iteration; launches {counts}")
        # the first scenario's config, as run_grid builds it
        base = {k: v for k, v in kw.items() if k not in (
            "algo", "env", "T", "seeds", "axes", "override")}
        _, ((scn, cfg), *_) = grid_scenarios(
            ScenarioGrid(seeds=FIG_SEEDS, axes=kw["axes"]), algo=kw["algo"],
            override=kw.get("override"), base=base)
        out, a = res[scn], resolve("algo", kw["algo"])
        for i, s in enumerate(FIG_SEEDS):
            one = a.run(exp.env, dataclasses.replace(cfg, seed=s), FIG_T,
                        device=dev)
            same = np.array_equal(one["returns"], out["returns"][i]) and \
                np.array_equal(one[a.carry_hist].cpu().numpy(),
                               out[a.carry_hist][i])
            if not same:
                raise AssertionError(f"{label} {scn} seed {s}: the grid's "
                                     f"history differs from the single run")
        log(f"[experiment] {label} {res.scenario_name(scn)}: each seed's "
            f"returns and final iterate bit-equal to its single run")
    return totals


def phase_telemetry(dev):
    """``telemetry=True`` on the card at T=4 under an ``obs.MemorySink``:
    returns, coins, diameter and θ bit-identical to the run without it
    (the same seed, so the same draws), one tap per iteration, and the
    launches of the telemetry run counted: the run's own row plus the
    rejection mask's kernels (Krum's scores: one gram, one krum_score).
    Returns the launches per kernel of the telemetry runs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.byzpg import run_byzpg
    from repro_torch.core.decbyzpg import run_decbyzpg
    from repro_torch.kernels import dispatch

    T = 4
    runs = byzpg_runs()[:2] + main_runs()[:1]
    totals = {}
    for label, env, _, cfg, per_iter in runs:
        algo = "decbyzpg" if label == "cartpole" else "byzpg"
        run = run_decbyzpg if algo == "decbyzpg" else run_byzpg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = run(env, cfg, T, device=dev)
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t0
        sink = obs.MemorySink()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with obs.telemetry(sink):
            on = run(env, dataclasses.replace(cfg, telemetry=True), T,
                     device=dev)
        torch.cuda.synchronize()
        t_on = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        extra = {"gram": 1, "krum_score": 1} \
            if cfg.aggregator.name == "krum" else {}
        want = {k: (per_iter.get(k, 0) + extra.get(k, 0)) * T
                for k in set(per_iter) | set(extra)}
        _check_launches(f"{label} telemetry", counts, want)
        _add(totals, counts)
        carry = "theta" if algo == "decbyzpg" else "vec"
        keys = ["returns", "coins"] + (["diameter"] if algo == "decbyzpg"
                                       else [])
        for k in keys:
            if not np.array_equal(on[k], off[k]):
                raise AssertionError(f"{label}: telemetry changed {k}")
        if not torch.equal(on[carry], off[carry]):
            raise AssertionError(f"{label}: telemetry changed {carry}")
        taps = [r for r in sink.records if r["stream"] == algo]
        if [int(r["t"]) for r in taps] != list(range(T)) or \
                on["rejected"].shape != (T, cfg.K):
            raise AssertionError(f"{label}: {len(taps)} taps for T={T}")
        log(f"[telemetry] {label} ({algo}): {', '.join(keys)} and {carry} "
            f"bit-identical to the run without telemetry; {len(taps)} taps; "
            f"grad_norm={np.round(on['grad_norm'], 4).tolist()}; "
            f"aggregator_confusion={on['aggregator_confusion']}; launches "
            f"{ {k: v for k, v in counts.items() if v} }; ms/iter "
            f"{t_off / T * 1e3:.3f} off, {t_on / T * 1e3:.3f} on")
    return totals


def phase_byzpg_cpu_agreement(dev):
    """Small ByzPG runs on the card against the same runs on the CPU
    (plain versions), fed the same draws and θ₀: bucketed RFA, Krum and
    the trimmed mean at K=13, n_byz=3."""
    import numpy as np
    import torch
    from repro_torch.core.byzpg import ByzPGConfig, run_byzpg
    from repro_torch.core.noise import draw_byzpg_noise
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.policy import resolve_policy

    env = make_cartpole(horizon=32)
    small = dict(K=13, n_byz=3, attack="large_noise(sigma=10)", N=8, B=2)
    T = 3
    for label in ("rfa", "krum", "trimmed_mean"):
        cfg = ByzPGConfig(**small, aggregator=label)
        policy = resolve_policy(cfg, env)
        gen = torch.Generator()
        gen.manual_seed(1)
        theta0 = policy.init(gen)
        noise = [draw_byzpg_noise(gen, cfg, env, policy.d, t)
                 for t in range(T)]
        on_card = [type(nz)(*(None if x is None else x.to(dev) for x in nz))
                   for nz in noise]
        cpu = run_byzpg(env, cfg, T, device="cpu", theta0=theta0,
                        noise=noise)
        gpu = run_byzpg(env, cfg, T, device=dev, theta0=theta0.to(dev),
                        noise=on_card)
        if not np.array_equal(cpu["coins"], gpu["coins"]):
            raise AssertionError(f"byzpg {label}: card/CPU coins differ")
        np.testing.assert_allclose(gpu["returns"], cpu["returns"], rtol=1e-5)
        th_err = (gpu["vec"].cpu() - cpu["vec"]).abs().max().item()
        if not th_err <= 1e-4:
            raise AssertionError(f"byzpg {label}: card/CPU theta differ by "
                                 f"{th_err} > 1e-4")
        log(f"[check] card vs CPU plain path, byzpg {label} (K=13, n_byz=3, "
            f"T={T}, coins {cpu['coins'].astype(int).tolist()}): coins "
            f"equal, returns within rtol 1e-5, theta max abs err "
            f"{th_err:.3e} (tol 1e-4)")


def phase_checkpoint(dev, byzpg_out):
    """``byzpg_cartpole``'s policy parameters saved and restored onto the
    card bit for bit, then one request served by ``serve()`` through
    ``policy_params(checkpoint=)``: the same tokens as serving the same
    parameters directly, and flash attention once per layer per prefill.
    Returns the launches per kernel of the served request."""
    import os
    import tempfile
    import torch
    from repro_torch import checkpoint
    from repro_torch.core.registry import resolve
    from repro_torch.core.tree import tree_paths
    from repro_torch.kernels import dispatch
    from repro_torch.serving import (default_buckets, make_traffic,
                                     policy_params, serve)

    params = byzpg_out["params"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "byzpg_cartpole.npz")
        checkpoint.save(params, path)
        back = checkpoint.restore(params, path, device=dev)
        pairs = list(zip(tree_paths(params), tree_paths(back)))
        if not all(ka == kb and b.device.type == dev.type
                   and torch.equal(a, b)
                   for (ka, a), (kb, b) in pairs):
            raise AssertionError("byzpg_cartpole params: the restored "
                                 "archive differs")
        spec = "transformer(arch='llama3.2-1b', n_layers=2, d_model=64, " \
            "n_heads=2)"
        env = resolve("env", "cartpole(horizon=32)")
        pol = resolve("policy", spec, env=env)
        direct = policy_params(pol, key=0, device=dev)
        ppath = os.path.join(tmp, "policy.npz")
        checkpoint.save(direct, ppath)
        kw = dict(n_requests=1, slots=4, max_new=16, realtime=False,
                  device=dev)
        want = serve(spec, env, params=direct, **kw).results[0].tokens
        torch.cuda.synchronize()
        dispatch.reset_launches()
        report = serve(spec, env, checkpoint=ppath, **kw)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
    flash = pol.model_cfg.n_layers * (len(default_buckets(8)) + 1)
    _check_launches("checkpoint serve", counts, {"flash_attention": flash})
    _check_served("checkpoint serve", report, make_traffic(
        1, seed=0, rate_rps=50.0, max_new=16, obs_dim=env.obs_dim),
        env.n_actions)
    got = report.results[0].tokens
    if got != want:
        raise AssertionError(f"served from the checkpoint {got}, directly "
                             f"{want}")
    log(f"[checkpoint] byzpg_cartpole params ({len(pairs)} arrays) restored "
        f"onto {dev} bit for bit; one request served through "
        f"policy_params(checkpoint=): tokens {got} equal to serving the "
        f"parameters directly, flash launches {counts['flash_attention']}")
    return counts


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
            _check_launches(label, counts, {"flash_attention": want_flash})
            _add(totals, counts)
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
    phase_policy_cpu_agreement(dev, tol)


#: a transformer policy at head dim 48, which the flash kernel runs
#: zero-padded to 64
POLICY_HD48 = "transformer(d_model=96, n_heads=2)"


def phase_policy_cpu_agreement(dev, tol):
    """``serve()`` with the :data:`POLICY_HD48` policy on the card and on
    the CPU, the same weights (drawn on the CPU): the card's prefills must
    go through the flash kernel, and the greedy streams must equal the
    CPU's unbatched ones up to each request's first step whose top-1
    margin is within ``tol``."""
    import numpy as np
    import torch
    from repro_torch.core.registry import resolve
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import decode_step, prefill, tree_map
    from repro_torch.serving import make_traffic, serve
    env = resolve("env", "cartpole(horizon=32)")
    pol = resolve("policy", POLICY_HD48, env=env)
    cfg = pol.model_cfg
    if cfg.resolved_head_dim != 48:
        raise AssertionError(f"{POLICY_HD48}: head dim "
                             f"{cfg.resolved_head_dim}, expected 48")
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_params = pol.init(gen)
    n, max_new = 8, 8
    streams, launched = {}, {}
    for d, params in (("cpu", cpu_params),
                      (dev, tree_map(lambda t: t.to(dev), cpu_params))):
        before = dispatch.launch_counts()["flash_attention"]
        report = serve(pol, env, params=params, n_requests=n, slots=4,
                       max_new=max_new, realtime=False, warmup=False,
                       device=d)
        torch.cuda.synchronize()
        launched[str(d)] = dispatch.launch_counts()["flash_attention"] - before
        streams[str(d)] = {r.uid: r.tokens for r in report.results}
    # one flash launch per layer per prefill on the card, none on the CPU
    if launched != {"cpu": 0, str(dev): cfg.n_layers * n}:
        raise AssertionError(f"{POLICY_HD48}: flash launches {launched}, "
                             f"expected {cfg.n_layers * n} on the card")
    compared = 0
    traffic = make_traffic(n, seed=0, rate_rps=50.0, max_new=max_new,
                           obs_dim=env.obs_dim)
    for req in traffic:
        pe = torch.zeros((1, cfg.n_prefix_embeds, cfg.d_model))
        pe[0, 0, :req.obs.shape[0]] = torch.from_numpy(req.obs)
        logits, cache = prefill(cfg, cpu_params, torch.zeros(
            (1, 1), dtype=torch.long), pe, cache_len=cfg.n_prefix_embeds
            + 1 + req.max_new)
        row, margins, want = logits[0, -1, :env.n_actions], [], []
        for i in range(req.max_new):
            top = torch.topk(row, 2).values
            margins.append((top[0] - top[1]).item())
            tok = torch.argmax(row)
            want.append(int(tok))
            if i + 1 < req.max_new:
                logits, cache = decode_step(cfg, cpu_params, tok[None],
                                            cache)
                row = logits[0, 0, :env.n_actions]
        m = next((i for i, x in enumerate(margins) if x <= tol),
                 len(margins))
        cpu_s, card_s = streams["cpu"][req.uid], streams[str(dev)][req.uid]
        if cpu_s != want or card_s[:m] != want[:m] \
                or len(card_s) != len(want):
            raise AssertionError(f"{POLICY_HD48} request {req.uid}: card "
                                 f"{card_s}, CPU {cpu_s}, unbatched {want}, "
                                 f"margins {np.round(margins, 6).tolist()}")
        compared += m
    log(f"[check] card vs CPU, {POLICY_HD48} (head dim 48 on the hd 64 "
        f"kernel, {launched[str(dev)]} flash launches on the card): greedy "
        f"streams equal over {compared} of "
        f"{sum(r.max_new for r in traffic)} tokens under the margin rule "
        f"(tol {tol})")


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
    byzpg_totals, byzpg_out = phase_byzpg(dev)
    _add(totals, byzpg_totals)
    phase_byzpg_cpu_agreement(dev)
    _add(totals, phase_experiment(dev))
    _add(totals, phase_telemetry(dev))
    _add(totals, phase_serving(dev))
    phase_serving_cpu_agreement(dev)
    _add(totals, phase_checkpoint(dev, byzpg_out))
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
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
