"""Continuous-batching serving demo on the PyTorch/CUDA port: the
aggregated transformer policy behind the `repro_torch.serving` engine,
driven by simulated user traffic.

32+ requests arrive staggered (Poisson at --rate req/s); the fixed-slot
engine prefills each into a free slot (flash attention on the card),
decodes all occupied slots in one step per tick, and recycles slots as
budgets complete. Per-request latency records and queue-depth/slot-
occupancy gauges stream through `repro_torch.obs`; the summary reports
p50/p99 latency and aggregate tokens/sec. Runs on CUDA; ``--device cpu``
runs the plain PyTorch versions.

  python examples_torch/serve_decode.py --requests 32 --slots 4 [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import make_env, obs, resolve, resolve_device  # noqa: E402
from repro_torch.serving import (PolicyServer, engine_for_policy,  # noqa: E402
                                 make_traffic, policy_params)


def policy_spec(arch: str) -> str:
    return (f"transformer(arch='{arch}', n_layers=2, d_model=64, "
            f"n_heads=2)")


def main(argv=None, params=None):
    """Run the example; returns the ``ServeReport``. ``params`` serves
    the given parameter tree instead of a fresh init (a test hands it
    parameters carried over from the reference)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean request arrival rate (req/s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--offline", action="store_true",
                    help="virtual-clock replay (deterministic; no "
                         "queueing delay in the latencies)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    env = make_env("cartpole(horizon=32)")
    policy = resolve("policy", policy_spec(args.arch), env=env)

    # θ from one generator seeded with --seed; the traffic's observation
    # vectors are host-side numpy seeded alike (traffic.py) and never
    # touch the generator
    if params is None:
        params = policy_params(policy, key=args.seed, device=dev)

    engine = engine_for_policy(policy, params, slots=args.slots,
                               max_new=args.max_new, max_prompt=8,
                               device=dev)
    server = PolicyServer(engine)           # warmup runs every bucket
    traffic = make_traffic(args.requests, seed=args.seed,
                           rate_rps=args.rate, max_new=args.max_new,
                           obs_dim=env.obs_dim)

    with obs.telemetry() as rec:
        report = server.run_offline(traffic) if args.offline \
            else server.run(traffic)
        n_records = len(rec.stream("serve.request"))
        peak_busy = max((r["slots_busy"] for r in rec.stream("serve.gauge")),
                        default=0)

    s = report.summary()
    obs.progress(f"{args.requests} requests on {args.slots} slots "
                 f"({'offline' if args.offline else 'realtime'}): "
                 f"p50={s['latency_p50_ms']}ms p99={s['latency_p99_ms']}ms "
                 f"ttft_p50={s['ttft_p50_ms']}ms "
                 f"{s['tokens_per_s']} tok/s "
                 f"({s['total_tokens']} tokens in {s['wall_s']}s)")
    obs.progress(f"telemetry: {n_records} serve.request records, "
                 f"peak occupancy {peak_busy}/{args.slots} slots")
    for r in report.results[:4]:
        obs.progress(f"  uid={r.uid}: {r.tokens}")
    return report


if __name__ == "__main__":
    main()
