"""Serving driver: continuous-batching decode on the GPU.

The port of the JAX package's ``launch/serve.py``. Two modes share the
``repro_torch.serving`` engine:

* **LM traffic** (default): any ported architecture (reduced or full
  width), token-prompt requests over its vocabulary::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --prompt-len 512 --gen 32 --slots 8 --requests 24 --offline

* **policy traffic** (``--policy``): the transformer policy through the
  ``repro_torch.serving.serve`` front door (observation requests through
  the prefix-embedding frontend)::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --policy "transformer(arch='llama3.2-1b', n_layers=2, \\
    d_model=64, n_heads=2)"

Weights are random, drawn from ``--seed``. Runs on CUDA; ``--device cpu``
runs the plain PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.models.model import init_params
from repro_torch.serving import (DecodeEngine, PolicyServer, make_traffic,
                                 progress, serve)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="policy spec string: serve observation traffic "
                         "through repro_torch.serving.serve instead of LM "
                         "token traffic")
    ap.add_argument("--env", default="cartpole(horizon=32)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offline", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.policy is not None:
        report = serve(policy=args.policy, env=args.env, key=args.seed,
                       n_requests=args.requests, rate_rps=args.rate,
                       slots=args.slots, max_new=args.gen, seed=args.seed,
                       realtime=not args.offline, device=dev)
        progress("policy serve", **report.summary())
        return

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = init_params(cfg, args.seed, device=dev)
    engine = DecodeEngine(cfg, params, slots=args.slots, max_new=args.gen,
                          max_prompt=args.prompt_len, device=dev)
    server = PolicyServer(engine)
    traffic = make_traffic(
        args.requests, seed=args.seed, rate_rps=args.rate,
        max_new=args.gen, vocab=cfg.vocab_size,
        prompt_lens=tuple(p for p in (1, 4, 8, args.prompt_len)
                          if p <= args.prompt_len))
    report = server.run_offline(traffic) if args.offline \
        else server.run(traffic)
    progress(f"lm serve arch={cfg.name}", **report.summary())
    for r in report.results[:2]:
        progress(f"  uid={r.uid}: {r.tokens[:12]}")


if __name__ == "__main__":
    main()
