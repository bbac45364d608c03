#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is non-zero):

1. Card: the GPU's name and power limit, as ``nvidia-smi`` reports them.
2. Build: ``kernels/csrc/aggregation.cu`` with ``nvcc`` for ``sm_90a``.
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
5. The kernel table as one JSON line, then
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
REPLACES = {
    "gram": "src/repro/kernels/pairwise_dist/pairwise_dist.py:30",
    "weiszfeld": "src/repro/kernels/rfa/rfa.py:76",
    "wsum": "src/repro/kernels/rfa/rfa.py:86",
    "krum_score": "src/repro/kernels/krum_score/krum_score.py:44",
    "trimmed_mean": "src/repro/kernels/trimmed_mean/trimmed_mean.py:29",
    "gossip_reduce": "src/repro/kernels/gossip_reduce/gossip_reduce.py:50",
    "neighbor_reduce":
        "src/repro/kernels/gossip_reduce/gossip_reduce.py:80",
}
# the input each kernel sees most on the main path: gram from MDA's rounds
# and weiszfeld and wsum on the 7 bucket means (CartPole, n_byz=3); the
# Krum, trimmed-mean and cw* kernels at the CartPole runs of main_runs()
HEADLINE = {"gram": (13, 13, 386), "weiszfeld": (13, 7, 386),
            "wsum": (13, 7, 386),
            "krum_score": "x (1, 13, 386) n_near=8",
            "trimmed_mean": "(1, 13, 386) n_trim=3",
            "gossip_reduce": "(13, 386) P=13 trimmed n_trim=3",
            "neighbor_reduce": "(13, 13, 386) median"}
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
    must launch exactly the kernels of its row, and every kernel must
    launch on some run."""
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
    missing = [name for name in dispatch.kernels()
               if totals.get(name, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return totals


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
    log_kernel_rows(rows)
    totals = phase_main_path(dev)
    phase_cpu_agreement(dev)
    for m in ("jax", "repro"):
        if m in sys.modules:
            raise AssertionError(f"{m} was imported")
    kernels = []
    for name in REPLACES:
        head = rows[(name, HEADLINE[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
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
