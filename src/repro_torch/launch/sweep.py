"""Resumable sweep CLI over the windowed sweep service: the port of the
JAX package's ``launch/sweep.py``, with the same flags and summary lines.

Runs a DecByzPG/ByzPG scenario grid as a long-running, resumable job:
T is chunked into ``--windows`` windows, per-window carries and generator
states land under ``--out`` next to the sweep manifest, and a re-launch
with ``--resume`` (or the same ``--out``) continues from the last
committed window; completed groups are reloaded without running
anything.

Axes sweep any config field: repeat ``--axis name=v1,v2,...`` (values
parsed as int/float when they look like numbers, component spec strings
otherwise); ``--set name=value`` pins base config fields the same way.

Several processes: launch each with ``--processes N --process-id I
--coordinator HOST:PORT`` (each process takes a card, ``LOCAL_RANK`` or
its id modulo the cards; the group is NCCL where each has a card of its
own, gloo where they share one, and the sweep's host objects go over
gloo either way):
``--mode span`` (the default then) splits every group's seeds over the
processes and gathers them after each window, ``--mode shard`` assigns
whole groups to processes (greedy LPT) and merges results through the
shared ``--out`` directory.

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions of the
kernels on the CPU instead. ``--telemetry-out DIR`` streams the
``sweep.window`` / ``sweep.partial`` records to ``DIR/metrics.jsonl`` and
writes the run manifest, with the kernels' launch counts, to
``DIR/manifest.json``.

  PYTHONPATH=src python -m repro_torch.launch.sweep --algo decbyzpg \\
      --env "cartpole(horizon=100)" --T 60 --seeds 3 --windows 4 \\
      --axis "eta=5e-3,1e-2" --axis "attack=none,large_noise(sigma=10)" \\
      --set K=5 --set n_byz=1 --out sweeps/fig2
  # preempted? pick it up again:
  PYTHONPATH=src python -m repro_torch.launch.sweep --resume sweeps/fig2
"""
import argparse
import ast
import contextlib
import os

from repro_torch import obs
from repro_torch.distributed.sharding import (init_distributed,
                                              leave_distributed)
from repro_torch.sweep import SweepRunner


def _parse_value(text: str):
    """CLI value -> int/float/bool/tuple when it parses, spec string
    otherwise (``hidden=(8,8)`` becomes a real tuple; ``rfa(nu=1e-3)``
    stays a string for the component registry)."""
    low = text.strip()
    if low in ("true", "True"):
        return True
    if low in ("false", "False"):
        return False
    for cast in (int, float):
        try:
            return cast(low)
        except ValueError:
            pass
    if low.startswith("("):
        try:
            val = ast.literal_eval(low)
            if isinstance(val, tuple):
                return val
        except (ValueError, SyntaxError):
            pass
    return low


def _parse_assign(text: str, flag: str):
    if "=" not in text:
        raise SystemExit(f"{flag} expects name=value, got {text!r}")
    name, _, value = text.partition("=")
    return name.strip(), value


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="windowed, resumable scenario-grid sweeps")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume the sweep recorded under DIR (grid "
                         "flags come from its manifest)")
    ap.add_argument("--algo", default="decbyzpg",
                    help="decbyzpg | byzpg")
    ap.add_argument("--env", default="cartpole",
                    help="env spec, e.g. cartpole(horizon=100)")
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--seeds", type=int, default=3,
                    help="seed batch size (seeds 0..N-1)")
    ap.add_argument("--windows", type=int, default=1,
                    help="window chunks T is split into (resume "
                         "granularity)")
    ap.add_argument("--axis", action="append", default=[],
                    metavar="NAME=V1,V2,...",
                    help="sweep axis over config-field values; repeat "
                         "per axis")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    metavar="NAME=VALUE",
                    help="pin a base config field; repeat per field")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="sweep directory (manifest + window "
                         "checkpoints + summary.json); omit for an "
                         "in-memory run")
    ap.add_argument("--stop-after", type=int, default=None,
                    metavar="N", help="execute at most N windows then "
                    "exit (crash simulation / cooperative preemption)")
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "local", "span", "shard"))
    ap.add_argument("--processes", type=int, default=1,
                    help="number of cooperating processes")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", default="localhost:7733",
                    metavar="HOST:PORT")
    ap.add_argument("--telemetry-out", default=None, metavar="DIR",
                    help="stream sweep.window / sweep.partial records "
                         "to DIR/metrics.jsonl and write the run "
                         "manifest to DIR/manifest.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    init_distributed(args.coordinator, args.processes, args.process_id,
                     device=args.device)
    try:
        _sweep(args)
    finally:
        if args.processes > 1:
            leave_distributed()


def _sweep(args) -> None:
    if args.resume is not None:
        runner = SweepRunner.resume(args.resume, mode=args.mode,
                                    device=args.device)
    else:
        axes = {}
        for item in args.axis:
            name, values = _parse_assign(item, "--axis")
            axes[name] = tuple(_parse_value(v)
                               for v in values.split(","))
        base = dict(_parse_assign(item, "--set") for item in args.sets)
        base = {k: _parse_value(v) for k, v in base.items()}
        runner = SweepRunner(algo=args.algo, env=args.env, T=args.T,
                             seeds=args.seeds, axes=axes,
                             windows=args.windows, out_dir=args.out,
                             mode=args.mode, device=args.device, **base)

    if args.telemetry_out:
        os.makedirs(args.telemetry_out, exist_ok=True)
        tele = obs.telemetry(obs.JsonlSink(
            os.path.join(args.telemetry_out, "metrics.jsonl")),
            obs.StdoutProgressSink())
    else:
        tele = contextlib.nullcontext()

    with tele:
        result = runner.run(max_windows=args.stop_after)
    if args.telemetry_out:
        obs.write_manifest(
            os.path.join(args.telemetry_out, "manifest.json"),
            extra={"sweep": runner._meta(), "out": runner.out_dir,
                   "mode": args.mode, "process_id": args.process_id,
                   "processes": args.processes,
                   "finished": result is not None})

    if result is None:
        out = runner.out_dir or "(no --out)"
        print(f"sweep paused after --stop-after {args.stop_after} "
              f"window(s); resume with: python -m "
              f"repro_torch.launch.sweep --resume {out}")
        return
    for name, entry in result.summary().items():
        print(f"{name}: final_return={entry['final_return_mean']:.3f} "
              f"+/- {entry['final_return_ci95']:.3f}")
    if runner.out_dir is not None:
        print(f"summary written to "
              f"{os.path.join(runner.out_dir, 'summary.json')}")


if __name__ == "__main__":
    main()
