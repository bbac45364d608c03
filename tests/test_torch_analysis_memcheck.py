"""The port's memory contracts (``repro_torch.analysis.memcheck``): on two
gloo ranks started once for the module, a sharded aggregator that gathers
whole rows breaks ``gather-footprint``, a block handed to rfa as a view
of the whole (K, D) stack breaks ``argument-footprint`` (its copy is
clean), and impossible bounds break ``argument-footprint`` and
``temp-footprint``, each beside a clean twin;
a collective's tensors leave the tally where the caller drops them,
whatever the backend's thread keeps; a contract of too many ranks is
``mesh-unavailable``; the real table runs
clean through its own rank processes; the table and D equal the
reference's (exact)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402

from repro_torch.analysis import memcheck  # noqa: E402
from repro_torch.analysis.memcheck import MemContract  # noqa: E402

#: the fixture ranks' stack width (the real table's D is memcheck's)
D_FIXTURE = 4096
FIXTURES = [
    MemContract("fixture_gather_rows", K=8, ranks=2),
    MemContract("rfa", K=8, ranks=2),
    MemContract("rfa", K=8, ranks=2, arg_slack=-10**9),
    MemContract("krum", K=8, ranks=2),
    MemContract("krum", K=8, ranks=2, temp_factor=0),
]


def _gather_rows_factory(K, n_byz, sharded=None):
    """A broken D-sharded mean: every row gathered whole on every rank."""
    from repro_torch.carriers.columns import local_columns, rewrap
    from repro_torch.core.aggregators import Aggregator

    def fn(x):
        local, sh = local_columns(x)
        rows = torch.stack([sh.gather_row(local[0, k])
                            for k in range(local.shape[1])])
        return rewrap(rows.mean(0)[None, sh.lo:sh.hi], sh)
    return Aggregator(fn)


def _unsplit_block(copy):
    """rfa handed this rank's columns of a whole (K, D) stack: a view
    (the rank holds the whole stack) or, the clean twin, a copy."""
    import torch.distributed as dist
    from repro_torch.carriers.columns import Shards, _chunk
    from repro_torch.launch.mesh import make_debug_mesh
    c = MemContract("rfa", K=8, ranks=2)
    lo, hi = _chunk(D_FIXTURE, c.ranks, dist.get_rank())
    gen = torch.Generator().manual_seed(0)
    block = torch.randn((c.K, D_FIXTURE), generator=gen)[:, lo:hi]
    x = Shards(make_debug_mesh(1, c.ranks, device_type="cpu"), 1,
               D_FIXTURE, lo, hi).wrap(block.clone() if copy else block)
    return memcheck.check_call(c, D_FIXTURE, x, "cpu")


def _rank_main(rank, world, port, kind, inp, dst):
    import pickle

    import torch.distributed as dist
    from repro_torch.core.registry import register
    register("aggregator", "fixture_gather_rows")(_gather_rows_factory)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        with open(inp, "rb") as f:
            table = pickle.load(f)
        out = [memcheck.check_rank(c, D_FIXTURE, "cpu") for c in table]
        out += [_unsplit_block(copy) for copy in (False, True)]
    finally:
        dist.destroy_process_group()
    torch.save(out, dst)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The fixture contracts on two ranks, and the real table through
    ``memcheck.run`` (its own ranks), all started together."""
    meshes = torch_ranks.Meshes(__name__, {"two": 2}, {"two": FIXTURES},
                                str(tmp_path_factory.mktemp("memcheck")))
    try:
        report = []
        real = memcheck.run("cpu", report=report)
        fixtures = meshes.results()["two"]
    finally:
        meshes.stop()
    return fixtures, real, report


def _rules(rank_out, i):
    return {f["rule"] for f in rank_out[i][0]}


def test_gathered_rows_flagged_sharded_rfa_clean(ranks):
    fixtures, _, _ = ranks
    for rank_out in fixtures:
        assert _rules(rank_out, 0) == {"gather-footprint"}
        # the clean rank's findings, whole, if it has any: a failure keeps
        # its text (the contract, the bytes, the message)
        assert _rules(rank_out, 1) == set(), rank_out[1]
        # a row crossed the ranks: D·4 bytes against K²·4·ranks
        assert max(rank_out[0][1]["gathers"]) >= D_FIXTURE * 4


def test_impossible_argument_bound_flagged(ranks):
    fixtures, _, _ = ranks
    for rank_out in fixtures:
        assert _rules(rank_out, 2) == {"argument-footprint"}


def test_unsplit_block_flagged_its_copy_clean(ranks):
    fixtures, _, _ = ranks
    n = len(FIXTURES)
    for rank_out in fixtures:
        assert _rules(rank_out, n) == {"argument-footprint"}
        assert _rules(rank_out, n + 1) == set()
        # the view holds the whole stack, the copy its columns (exact)
        assert rank_out[n][1]["args"] == 8 * D_FIXTURE * 4 + 8 * 8
        assert rank_out[n + 1][1]["args"] == 8 * D_FIXTURE * 4 // 2 + 8 * 8


def test_impossible_temp_bound_flagged_krum_clean(ranks):
    fixtures, _, _ = ranks
    for rank_out in fixtures:
        assert _rules(rank_out, 3) == set()
        assert _rules(rank_out, 4) == {"temp-footprint"}
        assert "krum(K=8)@2rank" in rank_out[4][0][0]["message"]


def test_collective_tensors_leave_the_tally_with_the_caller():
    """A backend that keeps a finished collective's tensors (its work
    object alive: gloo's worker thread drops its reference only when next
    scheduled) does not hold them in ``LiveBytes``: they leave the tally
    where the caller lets them go, so the peak does not depend on that
    thread. Here the caller keeps the work itself, the latest release."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with memcheck.LiveBytes("cpu") as mem:
            x = torch.ones(1024)
            parts = [torch.empty(1024)]
            work = dist.all_gather(parts, x, async_op=True)
            work.wait()
            assert torch.equal(parts[0], x)
            del x, parts
            y = torch.ones(1024)
            del y
        del work
    finally:
        dist.destroy_process_group()
    # x and its gathered part (4 KiB each), then y in x's place
    assert (mem.peak, mem.live) == (8192, 0)


def test_unavailable_mesh_flagged():
    found = memcheck.run("cpu", table=[MemContract("rfa", K=8, ranks=4096)])
    assert {f.rule for f in found} == {"mesh-unavailable"}


def test_real_contracts_clean(ranks):
    _, real, report = ranks
    assert real == []
    # every rank of every contract reported, within each bound
    assert len(report) == sum(c.ranks for c in memcheck.contracts())
    for r in report:
        assert r["args"] <= r["arg_bound"] and r["peak"] <= r["temp_bound"]
        assert max(r["gathers"]) <= r["gather_bound"]


def test_contract_table_and_width_equal_the_reference():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.analysis import memcheck as ref
    from repro.configs.base import get_config, reduced
    from repro.models.model import init_params
    assert [(c.aggregator, c.K, c.ranks, c.arg_slack, c.temp_factor)
            for c in memcheck.contracts()] == \
        [(c.aggregator, c.K, c.devices, c.arg_slack, c.temp_factor)
         for c in ref.contracts()]
    shapes = jax.eval_shape(
        lambda k: init_params(reduced(get_config("qwen2.5-3b")), k),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    D = int(sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)))
    assert memcheck.param_count() == D == 1_313_024
