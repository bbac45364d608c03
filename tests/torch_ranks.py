"""Gloo ranks for the multi-rank tests of the port, on the CPU.

A test module that holds ``_rank_main(rank, world, port, kind, inp,
dst)`` runs it in fresh processes, one per rank of each mesh ``kind``,
all meshes at a time (:func:`run_meshes`): each rank joins a gloo group
on a free localhost port, reads the pickled inputs ``inp``, runs its
cases and saves its results to ``dst``; the parent loads them in rank
order; :class:`Meshes` starts them for a module fixture that collects
their results later. :class:`CollectiveWatch` records, inside a rank,
the collectives (``CommDebugMode``) and every operator dispatched on a
DTensor.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
#: every rank's wall limit: a hung rank fails the module
TIMEOUT_S = 300


class DTensorOps:
    """While active, records every operator dispatched on a DTensor (the
    port's routes dispatch none: they work on local tensors) and, in
    ``gathers``, each c10d all-gather's output bytes (all its parts) and
    its group's size, in the order they run."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten
        seen = self.ops = []
        gathers = self.gathers = []
        allgather = torch.ops.c10d.allgather_.default

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func is allgather:
                    parts = args[0][0]
                    gathers.append((sum(p.nbytes for p in parts),
                                    len(parts)))
                if any(isinstance(a, DTensor)
                       for a in tree_flatten((args, kwargs))[0]):
                    seen.append(str(func))
                return func(*args, **kwargs)

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


class CollectiveWatch:
    """``CommDebugMode`` and :class:`DTensorOps` together; on exit their
    counts join ``out["comm"]`` (collective -> count) and
    ``out["dtensor_ops"]``, and each all-gather's (output bytes, group
    size) ``out["gathers"]``."""

    def __init__(self, out):
        from torch.distributed.tensor.debug import CommDebugMode
        self.out, self.comm, self.ops = out, CommDebugMode(), DTensorOps()
        out.setdefault("comm", {})
        out.setdefault("dtensor_ops", [])
        out.setdefault("gathers", [])

    def __enter__(self):
        self.comm.__enter__()
        self.ops.__enter__()
        return self

    def __exit__(self, *exc):
        self.ops.__exit__(*exc)
        self.comm.__exit__(*exc)
        for op, n in self.comm.get_comm_counts().items():
            name = str(op)
            self.out["comm"][name] = self.out["comm"].get(name, 0) + n
        self.out["dtensor_ops"] += self.ops.ops
        self.out["gathers"] += self.ops.gathers


def free_ports(n: int) -> list:
    """n distinct free localhost ports (held open together while
    chosen)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _spawn(module, kind, world, inp, tmp, port):
    """Start the ranks of one mesh; returns (procs, result paths)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    dsts = [os.path.join(tmp, f"{kind}-{r}.pt") for r in range(world)]
    code = (f"import sys; sys.path[:0] = [{SRC!r}, {TESTS!r}]; "
            f"import {module} as t; t._rank_main(*sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(port), kind,
         inp, dsts[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    return procs, dsts


def _finish(procs, dsts, kind):
    """The ranks' results, in rank order; None when rank 0 could not bind
    its port (taken between choosing it and binding it: spawn again). A
    rank that fails leaves its peers waiting on it, so the first failure
    stops the others; the assertion then carries every rank's return
    code and the end of each failed rank's stderr."""
    errs = {}
    try:
        for r, p in enumerate(procs):
            try:
                _, errs[r] = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                break
            if p.returncode and "EADDRINUSE" in errs[r]:
                return None
            if p.returncode:
                break
    finally:
        errs.update(stop(procs))
    failed = [r for r, p in enumerate(procs) if p.returncode]
    assert not failed, f"mesh {kind}: " + "\n".join(
        f"rank {r} exited {procs[r].returncode}: {errs.get(r, '')[-3000:]}"
        for r in failed)
    return [torch.load(d, weights_only=False) for d in dsts]


def stop(procs) -> dict:
    """Kill the ranks still running; returns their stderr by rank."""
    errs = {}
    for r, p in enumerate(procs):
        if p.poll() is None:
            p.kill()
            errs[r] = p.communicate()[1] + "\nstopped: a peer failed " \
                "or the mesh timed out"
    return errs


class Meshes:
    """Every mesh's ranks of test module ``module``, started at once:
    ``worlds`` maps a mesh kind to its number of ranks, ``inputs`` a kind
    to what its ranks read (pickled). :meth:`results` waits for them;
    :meth:`stop` kills any left (call it in a ``finally``)."""

    def __init__(self, module: str, worlds: dict, inputs: dict, tmp: str):
        self.module, self.worlds, self.tmp = module, worlds, tmp
        self.started, self.inps, self.out = {}, {}, None
        for kind in worlds:
            self.inps[kind] = os.path.join(tmp, f"inputs-{kind}.pkl")
            with open(self.inps[kind], "wb") as f:
                pickle.dump(inputs[kind], f)
        for kind, port in zip(worlds, free_ports(len(worlds))):
            self._start(kind, port)

    def _start(self, kind, port):
        self.started[kind] = _spawn(self.module, kind, self.worlds[kind],
                                    self.inps[kind], self.tmp, port)

    def results(self) -> dict:
        """Kind -> the ranks' results, in rank order (a rank whose port
        was taken is started again on another)."""
        if self.out is None:
            out = {}
            for kind in self.worlds:
                out[kind] = _finish(*self.started[kind], kind)
                if out[kind] is None:
                    self._start(kind, free_ports(1)[0])
                    out[kind] = _finish(*self.started[kind], kind)
                assert out[kind] is not None, f"mesh {kind}: no free port"
            self.out = out
        return self.out

    def stop(self):
        for procs, _ in self.started.values():
            stop(procs)


def run_meshes(module: str, worlds: dict, inputs: dict, tmp: str) -> dict:
    """:class:`Meshes` started and waited for: kind -> the ranks'
    results, in rank order. No rank outlives the call."""
    meshes = Meshes(module, worlds, inputs, tmp)
    try:
        return meshes.results()
    finally:
        meshes.stop()
