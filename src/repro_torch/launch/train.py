"""End-to-end federated training entry point: the port of the JAX package's
``launch/train.py``, with its flags and defaults plus ``--device``.

Runs DecByzPG over any ``--arch`` on the synthetic token pipeline:
Common-Sample PAGE coin -> per-agent gradients -> Byzantine attack (opt.)
-> robust aggregation -> per-agent Adam -> Avg-Agree_κ, through the tree
trainer of :mod:`repro_torch.distributed.fed_trainer`.

By default steps run in windows of ``--window`` (``fed_train_window``):
each window draws its PAGE coins at its start, one read to the host, and
every step's noise from the run's generator (seeded by ``--seed``),
which first draws θ₀.
``--no-fused`` runs the per-step loop instead, its coin from
``common_sample_coin`` (the reference's numpy coin, bit for bit).

Telemetry: ``--telemetry-out DIR`` turns on the obs layer (one ``fed``
record a step, streamed to ``DIR/metrics.jsonl``, and a run manifest
``DIR/manifest.json`` with the kernels' launch counts); ``--profile``
also writes the host spans as a Chrome trace ``DIR/trace.json``.
``--ckpt FILE`` saves agent 0's parameters (``repro_torch.checkpoint``).

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions on the
CPU (use ``--reduced`` there)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --agents 4 --steps 30 --byz 1 --attack large_noise
"""
import argparse
import contextlib
import os
import time

import torch

from repro_torch import obs, resolve_device
from repro_torch.checkpoint import save
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.engine import seed_generator
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.fed_trainer import (FedConfig,
                                                 common_sample_coin,
                                                 fed_noise, fed_train_step,
                                                 fed_train_window,
                                                 init_fed_state)


def _stack_batches(batches: list) -> dict:
    """List of per-step batch dicts -> one dict with a leading W axis."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def main(argv=None):
    """Run the CLI; returns the final ``FedState``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--byz", type=int, default=0)
    ap.add_argument("--attack", default="none",
                    help="attack spec, e.g. none | large_noise(sigma=10)")
    ap.add_argument("--aggregator", default="rfa",
                    help="aggregator spec, e.g. rfa | rfa(n_iter=16)")
    ap.add_argument("--optimizer", default="adam",
                    help="optimizer spec, e.g. adam | sgd(momentum=0.9)")
    ap.add_argument("--kappa", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--page-p", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--window", type=int, default=5,
                    help="steps per window (one host read each)")
    ap.add_argument("--no-fused", action="store_true",
                    help="per-step loop on common_sample_coin")
    ap.add_argument("--telemetry-out", default=None, metavar="DIR",
                    help="enable telemetry; write metrics.jsonl + "
                         "manifest.json (and trace.json with --profile) "
                         "under DIR")
    ap.add_argument("--profile", action="store_true",
                    help="host span tracing -> Chrome-trace trace.json "
                         "(implies telemetry; default DIR: telemetry/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out_dir = args.telemetry_out or ("telemetry" if args.profile else None)
    telemetry_on = out_dir is not None

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    fed = FedConfig(aggregator=args.aggregator, kappa=args.kappa,
                    n_byz=args.byz, attack=args.attack, lr=args.lr,
                    optimizer=args.optimizer, page_p=args.page_p,
                    seed=args.seed, telemetry=telemetry_on)
    K = args.agents
    # one generator draws θ₀ and then every coin and noise, in order: a
    # second generator seeded alike would start the run's draws from the
    # state the init drew from (keycheck's key-reuse)
    gen = seed_generator(fed.seed, dev)
    # the state is handed to each step or window from this list, so that
    # no variable here keeps a spent state alive while the next is made
    held = [init_fed_state(cfg, fed, K, gen, device=dev)]

    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        per_agent_batch=args.batch, n_agents=K,
        n_prefix_embeds=cfg.n_prefix_embeds if cfg.frontend != "none" else 0,
        d_model=cfg.d_model, seed=args.seed), device=dev)
    byz_mask = torch.arange(K, device=dev) < args.byz

    if telemetry_on:
        os.makedirs(out_dir, exist_ok=True)
        obs.get_tracer().clear()
        tele = obs.telemetry(
            obs.JsonlSink(os.path.join(out_dir, "metrics.jsonl")))
    else:
        tele = contextlib.nullcontext()

    mode = "legacy" if args.no_fused else "fused"
    obs.progress(
        f"arch={cfg.name} K={K} byz={args.byz} attack={fed.attack} "
        f"agg={fed.aggregator} opt={fed.optimizer} kappa={args.kappa} "
        f"mode={mode} device={dev}")
    t0 = time.time()

    def report(step_i, coin, metrics):
        obs.progress(f"step {step_i:4d} c={int(coin)} "
                     f"loss={float(metrics['loss']):.4f} "
                     f"diam={float(metrics['diameter']):.3e} "
                     f"({time.time() - t0:.1f}s)", step=step_i)

    with tele:
        if args.no_fused:
            for step_i in range(args.steps):
                c = common_sample_coin(step_i, args.seed, fed.page_p)
                with obs.host_span("train.step", step=step_i, coin=int(c)):
                    noise = fed_noise(gen, fed, held[0], args.byz)
                    state, metrics = fed_train_step(
                        cfg, fed, held.pop(), pipe.batch(step_i), byz_mask,
                        noise, large=c)
                    held.append(state)
                    del state, noise
                if step_i % max(args.steps // 10, 1) == 0 \
                        or step_i == args.steps - 1:
                    report(step_i, c, metrics)
        else:
            n_windows = -(-args.steps // args.window)
            report_every = max(n_windows // 10, 1)
            for w_i, w0 in enumerate(range(0, args.steps, args.window)):
                ts = list(range(w0, min(w0 + args.window, args.steps)))
                batches = _stack_batches([pipe.batch(t) for t in ts])
                with obs.host_span("train.window", window=w_i,
                                   steps=len(ts)):
                    state, metrics = fed_train_window(
                        cfg, fed, held.pop(), batches, byz_mask, ts, gen)
                    held.append(state)
                    del state
                if w_i % report_every == 0 or w_i == n_windows - 1:
                    last = {k: m[-1] for k, m in metrics.items()}
                    report(ts[-1], bool(last["coin"]), last)

        if args.ckpt:
            save(_agent0(held[0].params), args.ckpt)
            obs.progress(f"saved agent 0's params to {args.ckpt}")

        if telemetry_on:
            obs.write_manifest(
                os.path.join(out_dir, "manifest.json"),
                extra={"arch": cfg.name, "K": K, "n_byz": args.byz,
                       "attack": str(fed.attack),
                       "aggregator": str(fed.aggregator),
                       "steps": args.steps, "window": args.window,
                       "mode": mode, "device": str(dev)})
            if args.profile:
                obs.write_trace(os.path.join(out_dir, "trace.json"))
            obs.progress(f"telemetry written to {out_dir}/")
    return held.pop()


def _agent0(tree):
    if isinstance(tree, dict):
        return {k: _agent0(v) for k, v in tree.items()}
    return tree[0]


if __name__ == "__main__":
    main()
