"""The port's process layer (``repro_torch.distributed.sharding``): the
rule that picks each rank's backend and card, ``init_distributed`` as the
one place where the port, its examples and ``chip_smoke.py`` join a
process group, and the host objects (``gather_rows``, the sweep's
``broadcast_object``) going over ``host_group()``: the gloo group that
stands beside an NCCL world, here made beside a two-rank gloo world
(NCCL needs a card per rank; ``chip_smoke.py``'s phase 14 runs it)."""
import ast
import glob
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402

from repro_torch.distributed import sharding  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

#: (device type, ranks on the host, cards, asked backend) -> the backend,
#: or the error's words
BACKEND_CASES = {
    "cpu": ("cpu", 2, 0, None, "gloo"),
    "cpu, one rank": ("cpu", 1, 0, None, "gloo"),
    "one rank, one card": ("cuda", 1, 1, None, "nccl"),
    "a card per rank": ("cuda", 2, 2, None, "nccl"),
    "fewer ranks than cards": ("cuda", 2, 4, None, "nccl"),
    "two ranks share a card": ("cuda", 2, 1, None, "gloo"),
    "four ranks share a card": ("cuda", 4, 1, None, "gloo"),
    "five ranks on four cards": ("cuda", 5, 4, None, "gloo"),
    "gloo asked on own cards": ("cuda", 2, 2, "gloo", "gloo"),
    "gloo asked on a shared card": ("cuda", 2, 1, "gloo", "gloo"),
    "nccl asked on own cards": ("cuda", 4, 4, "nccl", "nccl"),
    "nccl asked on a shared card": ("cuda", 2, 1, "nccl",
                                    "needs a card per rank"),
    "nccl asked on the cpu": ("cpu", 2, 0, "nccl", "needs a card per rank"),
    "an unknown backend": ("cuda", 2, 2, "mpi", "'nccl' or 'gloo'"),
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_backend_rule(case):
    kind, ranks, cards, asked, want = BACKEND_CASES[case]
    if want in ("nccl", "gloo"):
        assert sharding.choose_backend(kind, ranks, cards, asked) == want
    else:
        with pytest.raises(ValueError, match=want):
            sharding.choose_backend(kind, ranks, cards, asked)


#: (rank, cards, LOCAL_RANK or None) -> the card
CARD_CASES = [(0, 1, None, 0), (1, 1, None, 0), (3, 4, None, 3),
              (5, 4, None, 1), (3, 2, "0", 0), (6, 4, "1", 1),
              (1, 2, "3", 1)]


@pytest.mark.parametrize("rank,cards,local,want", CARD_CASES)
def test_rank_card(rank, cards, local, want):
    assert sharding.rank_card(rank, cards, None if local is None
                              else int(local)) == want


def test_rank_card_needs_a_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.rank_card(0, 0)


class _Joins:
    """``init_distributed`` against a host of ``cards`` fake cards: the
    cards made current and the joins and groups asked for, recorded."""

    def __init__(self, monkeypatch, cards):
        self.current, self.joins, self.groups = [], [], []
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.cuda, "set_device", self.current.append)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda **kw: self.joins.append(kw))
        monkeypatch.setattr(dist, "new_group",
                            lambda **kw: self.groups.append(kw) or "side")
        monkeypatch.setattr(sharding, "_HOST_GROUP", [])
        for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)


def test_join_over_nccl_on_own_cards(monkeypatch):
    j = _Joins(monkeypatch, cards=4)
    dev = sharding.init_distributed("localhost:1", 2, 1, timeout_s=5)
    assert dev == torch.device("cuda", 1) and j.current == [dev]
    (kw,) = j.joins
    assert kw["backend"] == "nccl" and kw["device_id"] == dev
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["init_method"] == "tcp://localhost:1"
    # the host objects' gloo group, with the world's timeout
    assert [g["backend"] for g in j.groups] == ["gloo"]
    assert j.groups[0]["timeout"] == kw["timeout"]


def test_join_over_gloo_where_ranks_share_a_card(monkeypatch):
    j = _Joins(monkeypatch, cards=1)
    assert sharding.init_distributed("localhost:1", 2, 1) == \
        torch.device("cuda", 0)
    assert j.current == [torch.device("cuda", 0)] and not j.groups
    assert j.joins[0]["backend"] == "gloo" and \
        j.joins[0]["device_id"] is None
    with pytest.raises(ValueError, match="needs a card per rank"):
        sharding.init_distributed("localhost:1", 2, 1, backend="nccl")
    assert len(j.joins) == 1            # nothing joined, nothing retried


def test_join_reads_local_rank_and_local_world_size(monkeypatch):
    j = _Joins(monkeypatch, cards=2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    # rank 3 of 4 on two hosts of two cards: its host's second card
    dev = sharding.init_distributed("host:1", 4, 3)
    assert dev == torch.device("cuda", 1)
    assert j.joins[0]["backend"] == "nccl"


def test_join_on_the_cpu_and_alone(monkeypatch):
    j = _Joins(monkeypatch, cards=0)
    assert sharding.init_distributed("localhost:1", 2, 0,
                                     device="cpu") == torch.device("cpu")
    assert j.joins[0]["backend"] == "gloo" and not j.current
    # one process joins nothing and picks no card, unless asked to
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharding.init_distributed("localhost:1", 1, 0) == \
        torch.device("cuda")
    assert len(j.joins) == 1 and not j.current
    assert sharding.init_distributed("localhost:1", 1, 0,
                                     group_of_one=True) == \
        torch.device("cuda", 0)
    assert j.joins[-1]["backend"] == "nccl" and j.current == [
        torch.device("cuda", 0)]


def _calls_outside(path: str, name: str, allowed: str) -> list:
    """The lines of ``path`` that call ``name`` (a bare name or an
    attribute) outside a function called ``allowed``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    found = []

    def visit(node, inside):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside = inside or node.name == allowed
        if isinstance(node, ast.Call):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if called == name and not inside:
                found.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(tree, False)
    return found


def test_init_distributed_is_the_one_join():
    files = (glob.glob(os.path.join(REPO, "src", "repro_torch", "**",
                                    "*.py"), recursive=True)
             + glob.glob(os.path.join(REPO, "examples_torch", "*.py"))
             + [os.path.join(REPO, "chip_smoke.py")])
    sharding_py = os.path.join(REPO, "src", "repro_torch", "distributed",
                               "sharding.py")
    joins = {os.path.relpath(p, REPO): _calls_outside(
        p, "init_process_group",
        "init_distributed" if os.path.samefile(p, sharding_py) else "")
        for p in files}
    assert {p: lines for p, lines in joins.items() if lines} == {}
    # and the one join is there
    with open(sharding_py) as f:
        assert "dist.init_process_group(" in f.read()


def test_leave_distributed_is_the_one_teardown():
    """Every teardown goes through ``leave_distributed``, which drops the
    host group before it destroys the groups: a host group kept past
    ``destroy_process_group`` aborts its rank at exit (the gloo group and
    its store torn down with the interpreter)."""
    files = (glob.glob(os.path.join(REPO, "src", "repro_torch", "**",
                                    "*.py"), recursive=True)
             + glob.glob(os.path.join(REPO, "examples_torch", "*.py"))
             + [os.path.join(REPO, "chip_smoke.py")])
    sharding_py = os.path.join(REPO, "src", "repro_torch", "distributed",
                               "sharding.py")
    leaves = {os.path.relpath(p, REPO): _calls_outside(
        p, "destroy_process_group",
        "leave_distributed" if os.path.samefile(p, sharding_py) else "")
        for p in files}
    assert {p: lines for p, lines in leaves.items() if lines} == {}
    sharding._HOST_GROUP[:] = ["world", "side"]
    destroyed = []
    orig = dist.destroy_process_group
    dist.destroy_process_group = lambda: destroyed.append(
        list(sharding._HOST_GROUP))
    try:
        sharding.leave_distributed()
    finally:
        dist.destroy_process_group = orig
    assert destroyed == [[]] and sharding._HOST_GROUP == []


def _rank_main(rank, world, port, kind, inp, dst):
    """A gloo rank: ``host_group()`` is the world under gloo; then a gloo
    group beside the world stands in for an NCCL world's, and
    ``gather_rows`` and ``broadcast_object`` must go over it."""
    rank, world = int(rank), int(world)
    dev = sharding.init_distributed(f"localhost:{port}", world, rank,
                                    timeout_s=120, device="cpu")
    out = {"device": str(dev), "backend": dist.get_backend(),
           "plain": sharding.host_group() is None}
    try:
        side = dist.new_group(backend="gloo")
        sharding._HOST_GROUP[:] = [dist.group.WORLD, side]
        used = []
        orig = dist.all_gather_object, dist.broadcast_object_list

        def spy(fn):
            def call(*args, **kwargs):
                used.append(kwargs.get("group") is side)
                return fn(*args, **kwargs)
            return call

        dist.all_gather_object, dist.broadcast_object_list = map(spy, orig)
        try:
            mesh = sharding.LaneMesh(world, rank)
            out["rows"] = sharding.gather_rows(mesh, {
                "returns": np.full((2, 3), float(rank)),
                "theta": torch.arange(4.0).reshape(2, 2) + 10 * rank})
            out["window"] = sharding.broadcast_object(
                {"window": 3 + rank, "from": rank})
        finally:
            dist.all_gather_object, dist.broadcast_object_list = orig
        out["side_used"] = used
    finally:
        sharding.leave_distributed()
    torch.save(out, dst)


def test_host_objects_go_over_the_host_group(tmp_path):
    (ranks,) = torch_ranks.run_meshes(__name__, {"two": 2}, {"two": None},
                                      str(tmp_path)).values()
    for r, out in enumerate(ranks):
        assert out["device"] == "cpu" and out["backend"] == "gloo"
        assert out["plain"]              # gloo: the world carries them
        assert out["side_used"] == [True, True]
        np.testing.assert_array_equal(
            out["rows"]["returns"], np.repeat([0.0, 1.0], 2)[:, None]
            * np.ones((1, 3)))
        assert torch.equal(out["rows"]["theta"], torch.cat(
            [torch.arange(4.0).reshape(2, 2) + 10 * k for k in (0, 1)]))
        # rank 0's reading, on every rank
        assert out["window"] == {"window": 3, "from": 0}
