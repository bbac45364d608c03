"""Byzantine-tolerant federated LLM training on the PyTorch/CUDA port (the
paper's optimizer applied to an assigned architecture): 6 agents, 1
Byzantine sending LargeNoise, RFA aggregation + GDA agreement, PAGE coin
via Common-Sample.

Runs on the flat (K, D) parameter stack (DESIGN.md §3): every agent's
transformer ravels into one row and robust aggregation goes through the
registry aggregators (the CUDA kernels on the card). With ``--ranks N``
the script starts N − 1 more copies of itself as ranks on localhost (the
counterpart of the reference's ``--fake-devices``; each rank on its card
over NCCL where the host has a card per rank, else over gloo): the
trailing D axis is split over the mesh's "model" dimension and the
aggregators combine the ranks' Gram partials, with no parameter gather.
Rank 0 prints. Runs on CUDA; ``--device cpu`` runs the plain PyTorch
versions.

  python examples_torch/federated_llm.py --arch qwen2.5-3b [--device cpu]
  # the D-sharded route over two ranks (gloo on the CPU):
  python examples_torch/federated_llm.py --ranks 2 --device cpu
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import (get_config, obs, reduced,  # noqa: E402
                         resolve_device)
from repro_torch.core.engine import seed_generator  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import fed_trainer as ft  # noqa: E402
from repro_torch.distributed import (init_distributed,  # noqa: E402
                                      leave_distributed)
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

#: each rank's limit, on joining, on every collective and on its exit: a
#: hung rank fails the run
RANK_TIMEOUT_S = 600


def train(args, rank: int = 0, world: int = 1, dev=None) -> list:
    """The run on this process (rank ``rank`` of a joined group of
    ``world``, on its device ``dev``); rank 0 prints. Returns each step's
    (coin, honest loss, diameter)."""
    dev = resolve_device(args.device) if dev is None else dev
    cfg = reduced(get_config(args.arch))
    fed = ft.FedConfig(aggregator="rfa", kappa=3, n_byz=args.byz,
                       attack="large_noise", lr=2e-3, page_p=0.25)
    K = args.agents
    # one generator draws θ₀ and then every step's noise (the coins are
    # Common-Sample's numpy draws): a second generator seeded alike would
    # repeat the init's numbers
    gen = seed_generator(0, dev)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 64, 2, K, seed=0),
                         device=dev)
    mask = torch.arange(K, device=dev) < args.byz
    say = obs.progress if rank == 0 else (lambda *a, **k: None)

    if args.tree:
        state = ft.init_fed_state(cfg, fed, K, gen, device=dev)

        def step(state, batch, noise, c):
            return ft.fed_train_step(cfg, fed, state, batch, mask, noise,
                                     large=c)
        path = "tree-sharded"
    else:
        mesh = make_production_mesh(device_type=dev.type) if world > 1 \
            else None
        state, unravel = ft.init_flat_fed_state(cfg, fed, K, gen,
                                                device=dev, mesh=mesh)
        D = state.theta.shape[1]
        sharded = True if mesh is not None else None

        def step(state, batch, noise, c):
            return ft.fed_train_step_flat(cfg, fed, state, unravel, batch,
                                          mask, noise, large=c,
                                          sharded=sharded)
        path = (f"flat (K, D={D}) stack, "
                + (f"D-sharded over {world} "
                   f"{torch.distributed.get_backend()} ranks" if sharded
                   else "single device"))

    say(f"{cfg.name}: K={K}, {args.byz} Byzantine (LargeNoise), "
        f"RFA + GDA(kappa=3), PAGE p={fed.page_p} — {path}")
    rows = []
    for t in range(args.steps):
        c = ft.common_sample_coin(t, 0, fed.page_p)
        noise = ft.fed_noise(gen, fed, state, args.byz)
        state, m = step(state, pipe.batch(t), noise, c)
        loss, diam = float(m["loss"]), float(m["diameter"])
        rows.append((c, loss, diam))
        say(f"step {t:3d} coin={'N' if c else 'B'} "
            f"honest_loss={loss:.4f} diam={diam:.2e}")
    return rows


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_rank(args, rank: int, world: int, port: int) -> list:
    """Join the group on localhost:``port`` as ``rank`` of ``world``, on
    the rank's card (NCCL where each rank has one, else gloo) or the CPU,
    and run; a started rank gets the parent's arguments as they were
    parsed, so nothing here starts more ranks. Joining and every
    collective fail after RANK_TIMEOUT_S without the other ranks."""
    dev = init_distributed(f"localhost:{port}", world, rank,
                           timeout_s=RANK_TIMEOUT_S,
                           device=resolve_device(args.device))
    try:
        return train(args, rank, world, dev)
    finally:
        leave_distributed()


def main(argv=None) -> list:
    """Run the example; returns rank 0's (coin, honest loss, diameter)
    per step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--agents", type=int, default=6)
    ap.add_argument("--byz", type=int, default=1)
    ap.add_argument("--tree", action="store_true",
                    help="legacy tree trainer instead of the flat (K, D) "
                         "stack")
    ap.add_argument("--ranks", type=int, default=1,
                    help="split D over N ranks on this host: the "
                         "script starts N - 1 more copies of itself (the "
                         "flat trainer only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.ranks <= 1:
        return train(args)
    if args.tree:
        ap.error("--ranks splits the flat trainer's D; drop --tree")
    port = _free_port()
    # each started rank's errors go to a file of its own: a pipe that no
    # one reads until rank 0 is done would block a rank that fills it
    errs = [tempfile.TemporaryFile(mode="w+") for _ in range(1, args.ranks)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         str(args.ranks), str(port), json.dumps(vars(args))],
        stdout=subprocess.DEVNULL, stderr=err)
        for r, err in enumerate(errs, 1)]
    try:
        rows = run_rank(args, 0, args.ranks, port)
        for r, (p, err) in enumerate(zip(procs, errs), 1):
            if p.wait(timeout=RANK_TIMEOUT_S) != 0:
                err.seek(0)
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   f"{err.read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for err in errs:
            err.close()
    return rows


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank, world, port, parsed = sys.argv[2:6]
        run_rank(argparse.Namespace(**json.loads(parsed)), int(rank),
                 int(world), int(port))
    else:
        main()
