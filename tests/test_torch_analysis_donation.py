"""The port's state contracts (``repro_torch.analysis.donation``): the
functional rules fire on a step that writes into its input (through the
version counter, or around it through ``.data``), the in-place rules on a
tick that returns a fresh cache, ``site-drift`` on a renamed function, each
with a clean twin; every real site is clean, and the allocation measure
counts new storages, not views."""

import pytest
import torch

from repro_torch.analysis.donation import (FUNCTIONAL, IN_PLACE, Call, Site,
                                           check_call, check_site, checksum,
                                           sites)
from repro_torch.analysis.memcheck import LiveBytes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rules(findings):
    return {f.rule for f in findings}


def _state():
    g = torch.Generator()
    g.manual_seed(0)
    return {"theta": torch.randn((4, 64), generator=g),
            "opt": (torch.zeros(4), torch.ones((4, 64)))}


def _check(kind, call):
    return check_call("fixture", kind, call, "cpu")[0]


# -- functional -----------------------------------------------------------


def test_step_writing_its_input_flagged():
    state = _state()

    def step():
        state["theta"].add_(1.0)
        return {"theta": state["theta"], "opt": state["opt"]}

    assert _rules(_check(FUNCTIONAL, Call(step, state))) == {
        "input-written", "input-changed"}


def test_write_around_the_version_counter_flagged():
    state = _state()

    def step():
        state["opt"][1].data.mul_(2.0)       # .data keeps _version as is
        return state

    findings = _check(FUNCTIONAL, Call(step, state))
    assert _rules(findings) == {"input-changed"}
    assert "opt" in findings[0].message


def test_functional_step_clean():
    state = _state()
    step = lambda: {"theta": state["theta"] + 1.0,            # noqa: E731
                    "opt": tuple(t * 0.5 for t in state["opt"])}
    assert _check(FUNCTIONAL, Call(step, state)) == []


def test_checksum_sees_every_bit():
    x = torch.randn(1000)
    y = x.clone()
    y.view(torch.int32)[123] ^= 1            # one mantissa bit
    assert checksum(x) != checksum(y)
    assert checksum(x) == checksum(x.clone())
    assert checksum(torch.tensor([True, False])) == 1


# -- in-place -------------------------------------------------------------


def _cache():
    return {"blocks": {"k": torch.zeros((4, 2, 64, 2, 8)),
                       "v": torch.zeros((4, 2, 64, 2, 8))},
            "slot_pos": torch.full((2, 64), -1)}


def _buffers(cache):
    return {"blocks": cache["blocks"], "slot_pos": cache["slot_pos"]}


def test_tick_returning_a_fresh_cache_flagged():
    cache = _cache()

    def tick():
        fresh = {"blocks": {k: v.clone() for k, v in cache["blocks"].items()},
                 "slot_pos": cache["slot_pos"].clone()}
        fresh["blocks"]["k"][:, :, 3] = 1.0
        return fresh

    findings = _check(IN_PLACE, Call(tick, _buffers(cache), _buffers,
                                     cache["blocks"]["k"].nbytes))
    assert _rules(findings) == {"moved-buffer", "buffer-sized-allocation"}


def test_in_place_tick_clean():
    cache = _cache()

    def tick():
        cache["blocks"]["k"][:, :, 3] = torch.ones((4, 2, 2, 8))
        cache["slot_pos"][:, 3] = 3
        return cache

    assert _check(IN_PLACE, Call(tick, _buffers(cache), _buffers,
                                 cache["blocks"]["k"].nbytes)) == []


def test_live_bytes_counts_storages_not_views():
    x = torch.zeros((256, 256))
    with LiveBytes("cpu") as mem:
        v = x[:, :128].T                     # a view: nothing new
        y = x + 1.0                          # 256 KB, still live
        z = (x * 2.0).sum()                  # a freed temporary + 4 bytes
    assert (mem.peak, mem.live) == (2 * x.nbytes + 4, x.nbytes + 4)
    del v, y, z


# -- the site table -------------------------------------------------------


def test_site_drift_flagged():
    def must_not_build(device):
        raise AssertionError("a drifted site must not be run")

    site = Site("fixture", "src/repro_torch/serving/engine.py",
                "repro_torch.serving.engine:DecodeEngine.renamed_away",
                IN_PLACE, must_not_build)
    assert _rules(check_site(site)) == {"site-drift"}


def test_site_table_keeps_the_reference_names():
    from repro.analysis.donation import sites as ref_sites
    assert [s.name for s in sites()] == [s.name for s in ref_sites()]


@pytest.mark.parametrize("name", [s.name for s in sites()])
def test_real_sites_clean(name):
    site = next(s for s in sites() if s.name == name)
    report = []
    assert check_site(site, "cpu", report) == []
    if site.kind == IN_PLACE:
        assert report[0]["peak"] < report[0]["bound"]
