"""Per-rank memory contracts of the D-sharded aggregators: the counterpart
of the JAX package's ``analysis/memcheck.py``.

The reference compiles the sharded flat aggregators on a faked
multi-device mesh and bounds each device's ``memory_analysis()``. The
port has no compiler: each contract spawns its ranks in fresh
processes (``python -m repro_torch.analysis.memcheck --rank ...``, as the
reference spawns a forced-device subprocess), and each rank resolves
``resolve("aggregator", agg, K=K, n_byz=1, sharded=True)``, calls it on
its :class:`~repro_torch.carriers.columns.Shards` block of a (K, D)
stack and measures the call. Per rank, with shard = K·D·4 / ranks:

* ``argument-footprint`` — its arguments as the route reads them (the
  block ``local_columns`` takes from the ``Shards`` carrier and the
  receivers' permutation, each counted by the whole storage it holds)
  ≤ shard + ``arg_slack``: the rank holds its columns of the stack and
  no more, not a view into a whole (K, D) stack;
* ``temp-footprint`` — the peak live bytes allocated during the call
  (:class:`LiveBytes`) ≤ ``temp_factor`` · (shard + K²·4);
* ``gather-footprint`` — no ``all_gather`` receives more than K²·4·ranks
  bytes: the Gram partials cross the ranks, a gathered row never does;
* ``mesh-unavailable`` — the contract's ranks cannot start (more than
  ``MAX_RANKS``, or a rank that does not join).

D is the parameter count of reduced Qwen2.5-3B, from the port's
``param_shapes`` (1,313,024, the reference's ``jax.eval_shape`` count).
On one card the ranks place their blocks on it and gloo stages the
gathers through the host; where each rank has a card of its own they
join over NCCL (``sharding.init_distributed``) and the gathered parts
stay on the device, where ``LiveBytes`` counts them (NCCL's own buffers
it does not).

:class:`LiveBytes` is the suite's one allocation measure (the donation
pass uses it too): on the CPU a dispatch mode that tallies the live bytes
of the new storages each op returns (views share their base's storage and
are not counted; a storage's bytes leave the tally when it is freed), on
CUDA ``torch.cuda.max_memory_allocated`` above the start.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.analysis.findings import Finding

_AGG_PATH = "src/repro_torch/core/aggregators.py"
_MARK = "MEMCHECK_JSON:"
#: the most ranks a contract may spawn on one machine
MAX_RANKS = 8
#: a contract's wall limit, all its ranks together
TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# Allocation measure
# ---------------------------------------------------------------------------


class _Tally(TorchDispatchMode):
    def __init__(self, device: torch.device):
        super().__init__()
        self.device, self.live, self.peak = device, 0, 0
        self._tracked: set = set()
        # a storage may be freed on a collective's thread
        self._lock = threading.RLock()

    def _free(self, key, n) -> None:
        with self._lock:
            self._tracked.discard(key)
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            return _on_copies(func, args, kwargs)
        out = func(*args, **kwargs)
        inputs = {t.untyped_storage()._cdata
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._tracked:
                continue
            n = st.nbytes()
            with self._lock:
                self._tracked.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def _on_copies(func, args, kwargs):
    """A c10d collective run on copies of its tensors, waited for, its
    results copied back into the caller's tensors. A backend's thread
    drops its references to a finished collective's tensors only when it
    is next scheduled (gloo's worker, under load, held an ``all_gather``'s
    input and parts past the caller's next allocations), so a tally of
    the caller's own tensors would free them, and peak, as that thread
    happens to run. The copies are the backend's and are not tallied, as
    its own buffers are not."""
    pairs = {}

    def copy(t):
        if not isinstance(t, torch.Tensor):
            return t
        c = t.clone()
        pairs[id(c)] = (t, c)
        return c

    out = func(*tree_map(copy, args), **tree_map(copy, kwargs))
    for w in tree_flatten(out)[0]:
        if not isinstance(w, torch.Tensor) and hasattr(w, "wait"):
            w.wait()                # the work, boxed as a ScriptObject
    for t, c in pairs.values():
        t.copy_(c)
    return tree_map(lambda x: pairs[id(x)][0] if id(x) in pairs else x, out)


class LiveBytes:
    """While active, measures the bytes of new storages on ``device``:
    ``peak``, the most that were live at once above the start, and
    ``live``, what is still live at the end."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.peak = self.live = 0

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self._base = torch.cuda.memory_allocated(self.device)
        else:
            self._mode = _Tally(self.device)
            self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak = torch.cuda.max_memory_allocated(self.device) \
                - self._base
            self.live = torch.cuda.memory_allocated(self.device) - self._base
        else:
            self._mode.__exit__(*exc)
            self.peak, self.live = self._mode.peak, self._mode.live
        return False


class GatherWatch(TorchDispatchMode):
    """While active, records each c10d ``all_gather``'s received bytes
    (all its parts) in ``gathers``."""

    def __init__(self):
        super().__init__()
        self.gathers: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.c10d.allgather_.default:
            self.gathers.append(sum(p.nbytes for p in args[0][0]))
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# The contract table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemContract:
    """One per-rank footprint bound on ``ranks`` ranks.

    Bounds (bytes, per rank, f32 stacks), with shard = K·D·4 / ranks:

    * arguments ≤ ``shard + arg_slack``
    * peak live temporaries ≤ ``temp_factor * (shard + K*K*4)``
    * every ``all_gather`` ≤ ``K*K*4 * ranks``
    """
    aggregator: str
    K: int
    ranks: int
    arg_slack: int = 4096
    temp_factor: int = 4

    @property
    def name(self) -> str:
        return f"{self.aggregator}(K={self.K})@{self.ranks}rank"


def contracts() -> list:
    """The reference's table: both mesh sizes, both flat-path aggregators,
    the K of the paper-scale federated runs (K=8)."""
    out = []
    for ranks in (2, 4):
        for agg in ("krum", "rfa"):
            out.append(MemContract(aggregator=agg, K=8, ranks=ranks))
    return out


def param_count() -> int:
    """D: the parameters of reduced Qwen2.5-3B, from the shapes alone."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_size
    from repro_torch.models.model import param_shapes
    return tree_size(param_shapes(reduced(get_config("qwen2.5-3b"))))


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------


def check_rank(c: MemContract, D: int, device) -> tuple:
    """One rank's check of contract ``c`` in a joined group of
    ``c.ranks`` processes, on its own block of a (K, D) stack:
    ``(findings as dicts, measured bytes)``."""
    from repro_torch.carriers.columns import Shards, _chunk
    from repro_torch.core.engine import seed_generator
    from repro_torch.launch.mesh import make_debug_mesh
    dev = torch.device(device)
    mesh = make_debug_mesh(1, c.ranks, device_type=dev.type)
    rank = dist.get_rank()
    lo, hi = _chunk(D, c.ranks, rank)
    local = torch.randn((c.K, hi - lo), generator=seed_generator(rank, dev),
                        device=dev)
    return check_call(c, D, Shards(mesh, 1, D, lo, hi).wrap(local), dev)


def _storage_bytes(*tensors) -> int:
    """The bytes of the distinct storages behind ``tensors``: a view
    counts the whole storage it keeps alive."""
    seen = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}
    return sum(seen.values())


def check_call(c: MemContract, D: int, x, device) -> tuple:
    """Contract ``c`` on one sharded call of its aggregator on ``x``, this
    rank's D-sharded stack: the arguments are what the route reads,
    ``local_columns(x)``'s block and the receivers' permutation, each
    counted by the storage it holds (a block that is a view of a whole
    (K, D) stack holds the stack). ``(findings as dicts, measured
    bytes)``."""
    from repro_torch.carriers.columns import local_columns
    from repro_torch.core.engine import seed_generator
    from repro_torch.core.registry import resolve
    dev = torch.device(device)
    rank = dist.get_rank()
    perm = torch.argsort(torch.rand((1, c.K), generator=seed_generator(
        0, dev), device=dev), dim=1)
    agg = resolve("aggregator", c.aggregator, K=c.K, n_byz=1, sharded=True)
    agg(x, perm)                      # warm: first-call allocations
    with GatherWatch() as watch, LiveBytes(dev) as mem:
        out = agg(x, perm)
    del out
    shard = c.K * D * 4 // c.ranks
    args = _storage_bytes(local_columns(x)[0], perm)
    measured = dict(contract=c.name, rank=rank, args=args, peak=mem.peak,
                    gathers=watch.gathers, arg_bound=shard + c.arg_slack,
                    temp_bound=c.temp_factor * (shard + c.K * c.K * 4),
                    gather_bound=c.K * c.K * 4 * c.ranks)
    found = []
    if args > measured["arg_bound"]:
        found.append(dict(
            rule="argument-footprint",
            message=f"[{c.name}] rank {rank}'s arguments occupy {args} bytes "
                    f"> bound {measured['arg_bound']} (one K·D/ranks shard "
                    f"+ {c.arg_slack}) — the rank holds more than its "
                    f"columns of the stack"))
    if mem.peak > measured["temp_bound"]:
        found.append(dict(
            rule="temp-footprint",
            message=f"[{c.name}] rank {rank}'s temporaries peak at "
                    f"{mem.peak} bytes > bound {measured['temp_bound']} "
                    f"({c.temp_factor}·(shard + K²·4))"))
    big = [g for g in watch.gathers if g > measured["gather_bound"]]
    if big:
        found.append(dict(
            rule="gather-footprint",
            message=f"[{c.name}] rank {rank} received all_gathers of {big} "
                    f"bytes > bound {measured['gather_bound']} "
                    f"(K²·4·ranks) — a whole row or stack crossed the "
                    f"ranks"))
    return found, measured


def child_main(argv=None) -> int:
    """A rank: join the group, check the contract, print one
    ``MEMCHECK_JSON:`` line (findings are data, not a crash)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--contract", required=True)
    ap.add_argument("--D", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    from repro_torch.distributed.sharding import (init_distributed,
                                                  leave_distributed)
    c = MemContract(**json.loads(args.contract))
    dev = init_distributed(f"localhost:{args.port}", c.ranks, args.rank,
                           device=args.device, group_of_one=True)
    try:
        found, measured = check_rank(c, args.D, dev)
    finally:
        leave_distributed()
    print(_MARK + json.dumps({"findings": found, "measured": measured}),
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free localhost port, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(c: MemContract, D: int, device) -> list:
    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    port = free_port()
    spec = json.dumps(dataclasses.asdict(c))
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis.memcheck", "--rank",
         str(r), "--port", str(port), "--contract", spec, "--D", str(D),
         "--device", str(device)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(c.ranks)]


def _wait(procs) -> list:
    """Each rank's (stdout, stderr, return code), in rank order, within
    TIMEOUT_S for all of them. A rank that fails leaves its peers
    waiting on it in a collective, so once one has failed the others are
    stopped, not waited for."""
    deadline = time.monotonic() + TIMEOUT_S
    outs = {}
    try:
        for r, p in enumerate(procs):
            if any(q.poll() not in (None, 0) for q in procs):
                break
            try:
                outs[r] = p.communicate(timeout=max(
                    deadline - time.monotonic(), 0)) + (p.returncode,)
            except subprocess.TimeoutExpired:
                break
    finally:
        stopped = [p.poll() is None for p in procs]
        for p, stop in zip(procs, stopped):
            if stop:
                p.kill()
    for r, p in enumerate(procs):
        if r not in outs:
            out, err = p.communicate()
            note = "\nstopped: a peer failed or the contract timed out"
            outs[r] = (out, err + note if stopped[r] else err,
                       p.returncode)
    return [outs[r] for r in range(len(procs))]


def _collect(c: MemContract, outs) -> tuple:
    findings, measured = [], []

    def bad(rule, msg):
        findings.append(Finding("memcheck", rule, _AGG_PATH, 0, msg))

    for r, (out, err, rc) in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(_MARK)]
        if rc != 0 or not lines:
            rule = "mesh-unavailable" if "init_process_group" in err \
                or "timed out" in err else "subprocess-crash"
            bad(rule, f"[{c.name}] rank {r} exited {rc}: {err[-1000:]}")
            continue
        doc = json.loads(lines[-1][len(_MARK):])
        measured.append(doc["measured"])
        for f in doc["findings"]:
            bad(f["rule"], f["message"])
    return findings, measured


def run(device="cpu", table: Optional[list] = None,
        report: Optional[list] = None) -> list:
    """Check every contract of ``table`` (default :func:`contracts`), all
    contracts' ranks running at once; each rank's measured bytes are
    appended to ``report`` when given."""
    D = param_count()
    table = contracts() if table is None else table
    started, findings = [], []
    try:
        for c in table:
            if not 1 <= c.ranks <= MAX_RANKS:
                findings.append(Finding(
                    "memcheck", "mesh-unavailable", _AGG_PATH, 0,
                    f"[{c.name}] contract needs {c.ranks} ranks; a "
                    f"contract spawns 1 to {MAX_RANKS}"))
                continue
            started.append((c, _spawn(c, D, device)))
        for c, procs in started:
            outs = _wait(procs)
            if any("EADDRINUSE" in err for _, err, _ in outs):
                # the port was taken between choosing it and binding it
                outs = _wait(_spawn(c, D, device))
            found, measured = _collect(c, outs)
            findings.extend(found)
            if report is not None:
                report.extend(measured)
    finally:
        for _, procs in started:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return findings


if __name__ == "__main__":
    sys.exit(child_main())
