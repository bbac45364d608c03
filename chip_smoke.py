#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is non-zero):

1. Card: the GPU's name and power limit, as ``nvidia-smi`` reports them.
2. Build: ``kernels/csrc/aggregation.cu`` with ``nvcc`` for ``sm_90a``.
3. Kernels: ``gram``, ``weiszfeld`` and ``wsum`` against their plain
   PyTorch versions on the card, at the main path's shapes and one large
   stack; ``gram`` rerun for bit-identity; mean times of the kernel, the
   plain version and a library call (``torch.bmm``, timed only).
4. Main path: ``run_decbyzpg`` at the paper's full-width CartPole
   configuration (K=13, n_byz=3 ``large_noise(sigma=10)``, bucketing ∘
   RFA, MDA κ=6, horizon 200, d=386) for 8 iterations, then LunarLander
   with a (64, 64) tanh policy (d=4868) for 3; every kernel's launch count
   must grow. A small configuration then runs on the card and, with the
   same draws, on the CPU through the plain versions, and the two must
   agree.
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
SOURCE = "src/repro_torch/kernels/csrc/aggregation.cu"
REPLACES = {
    "gram": "src/repro/kernels/pairwise_dist/pairwise_dist.py:30",
    "weiszfeld": "src/repro/kernels/rfa/rfa.py:76",
    "wsum": "src/repro/kernels/rfa/rfa.py:86",
}
# the shape each kernel sees most on the main path (CartPole, n_byz=3):
# gram from MDA's rounds, weiszfeld and wsum on the 7 bucket means
HEADLINE = {"gram": (13, 13, 386), "weiszfeld": (13, 7, 386),
            "wsum": (13, 7, 386)}
N_ITER, NU = 32, 1e-6


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
            err=err, rel=err / scale, tol=tol,
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
            err=err, rel=err, tol=tol,
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
            err=err, rel=err / scale, tol=tol,
            ms=time_ms(lambda: weighted_sum(x, w), reps),
            plain_ms=time_ms(lambda: weighted_sum_plain(x, w),
                             max(reps // 10, 2), 1),
            library_ms=time_ms(lambda: torch.bmm(wv, x), reps),
            bound_ms=b[0], bound_by=b[1])
        del x, xt, g, g_plain
        torch.cuda.empty_cache()

    log("[kernels] name       shape (Bt,K,d)      max_abs_err  max_rel_err"
        "  tol          ms         plain_ms   library_ms bound_ms  bound_by")
    for (name, shape), r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
        log(f"[kernels] {name:10s} {str(shape):19s} {r['err']:.3e}    "
            f"{r['rel']:.3e}    {r['tol']:.3e}    {r['ms']:.6f}   "
            f"{r['plain_ms']:.6f}   {lib:10s} {r['bound_ms']:.6f}  "
            f"{r['bound_by']}")
    return rows


def phase_main_path(dev):
    """Drive ``run_decbyzpg`` as a user would, counting launches."""
    import numpy as np
    import torch
    from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
    from repro_torch.kernels import dispatch
    from repro_torch.rl.envs import make_cartpole, make_lunarlander

    runs = [
        ("cartpole", make_cartpole(horizon=200), 8,
         DecByzPGConfig(n_byz=3, attack="large_noise(sigma=10)")),
        ("lunarlander", make_lunarlander(), 3,
         DecByzPGConfig(hidden=(64, 64), activation="tanh")),
    ]
    totals = {name: 0 for name in dispatch.kernels()}
    for label, env, T, cfg in runs:
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
                and np.isfinite(out["diameter"]).all()):
            raise AssertionError(f"{label}: non-finite returns or diameter")
        if out["returns"].shape != (T,) or out["theta"].shape != (cfg.K, d):
            raise AssertionError(f"{label}: unexpected output shapes")
        if not bool(out["coins"][0]):
            raise AssertionError(f"{label}: coin at t=0 is not 1")
        for name, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{label}: kernel {name} was never "
                                     f"launched on the main path")
            totals[name] += n
        per_iter = {k: v / T for k, v in counts.items()}
        log(f"[main] {label}: d={d} T={T} ms/iter={secs / T * 1e3:.3f} "
            f"launches/iter={per_iter} returns={out['returns'].tolist()} "
            f"diameter={out['diameter'].tolist()} "
            f"coins={out['coins'].astype(int).tolist()}")
    return totals


def phase_cpu_agreement(dev):
    """A small run on the card against the same run on the CPU (plain
    versions), fed the same draws and θ₀."""
    import numpy as np
    import torch
    from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
    from repro_torch.core.noise import draw_step_noise
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.policy import resolve_policy

    env = make_cartpole(horizon=32)
    cfg = DecByzPGConfig(K=13, n_byz=3, attack="large_noise(sigma=10)",
                         N=8, B=2)
    T = 3
    policy = resolve_policy(cfg, env)
    gen = torch.Generator()
    gen.manual_seed(1)
    theta0 = policy.init(gen)
    noise = [draw_step_noise(gen, cfg, env, policy.d, t) for t in range(T)]
    on_card = [type(nz)(*(None if x is None else x.to(dev) for x in nz))
               for nz in noise]
    cpu = run_decbyzpg(env, cfg, T, device="cpu", theta0=theta0,
                       noise=noise)
    gpu = run_decbyzpg(env, cfg, T, device=dev, theta0=theta0.to(dev),
                       noise=on_card)
    # f32 sums in other orders on the two devices; the rollouts must pick
    # the same actions, so returns agree to rounding
    if not np.array_equal(cpu["coins"], gpu["coins"]):
        raise AssertionError("card/CPU coins differ")
    np.testing.assert_allclose(gpu["returns"], cpu["returns"], rtol=1e-5)
    th_err = (gpu["theta"].cpu() - cpu["theta"]).abs().max().item()
    if not th_err <= 1e-4:
        raise AssertionError(f"card/CPU theta differ by {th_err} > 1e-4")
    log(f"[check] card vs CPU plain path (K=13, n_byz=3, T={T}): coins "
        f"equal, returns within rtol 1e-5, theta max abs err {th_err:.3e} "
        f"(tol 1e-4)")


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
    totals = phase_main_path(dev)
    phase_cpu_agreement(dev)
    for m in ("jax", "repro"):
        if m in sys.modules:
            raise AssertionError(f"{m} was imported")
    kernels = []
    for name in ("gram", "weiszfeld", "wsum"):
        head = rows[(name, HEADLINE[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": max(rows[(name, s)]["err"] for s in MAIN_SHAPES),
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
