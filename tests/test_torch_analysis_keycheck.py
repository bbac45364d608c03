"""The port's draw recorder (``repro_torch.analysis.keycheck``): each rule
fires on a broken fixture loop (anchored in this file) and stays silent
on its clean twin, and the real entry points are clean, the training
CLI's init included (its θ₀ and its run once started from one state)."""

import sys

import pytest
import torch

from repro_torch.analysis.keycheck import Tap, check, record, run
from repro_torch.core.noise import StepNoise

_THIS = "test_torch_analysis_keycheck.py"
K, M, H, A = 4, 3, 5, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _rules(findings):
    return {f.rule for f in findings}


def _assert_context(findings):
    for f in findings:
        assert f.path.endswith(_THIS) and f.line > 0, f.format()


def _step(carry, noise, t):
    """The fixture loops' step: consumes a StepNoise."""
    return carry + noise.gumbel.sum() + noise.s0.sum() + noise.coin


_TAPS = (Tap(sys.modules[__name__], "_step", lambda a, k: a[1]),)


def _noise(gen, gumbel=None):
    coin = torch.rand((), generator=gen) < 0.5
    s0 = torch.rand((K, M, 4), generator=gen)
    if gumbel is None:
        gumbel = torch.rand((K, M, H, A), generator=gen)
    return StepNoise(coin, s0, gumbel, None, None, None)


def _drive(T, noise_of):
    carry = torch.zeros(())
    for t in range(T):
        carry = _step(carry, noise_of(t), t)


def _check(fn):
    return check(record(fn, _TAPS), "fixture")


# -- key-reuse ----------------------------------------------------------------


def test_cloned_generator_state_flagged():
    def bad():
        g = _gen(0)
        twin = torch.Generator()
        twin.set_state(g.get_state())
        torch.rand((3,), generator=g)
        torch.randn((3,), generator=twin)

    findings = _check(bad)
    assert _rules(findings) == {"key-reuse"}
    _assert_context(findings)


def test_generators_seeded_alike_flagged_distinct_seeds_clean():
    findings = _check(lambda: [torch.rand((3,), generator=_gen(s))
                               for s in (5, 5)])
    assert _rules(findings) == {"key-reuse"}
    assert _check(lambda: [torch.rand((3,), generator=_gen(s))
                           for s in (5, 6)]) == []


# -- global-generator ---------------------------------------------------------


def test_default_generator_draw_flagged():
    findings = _check(lambda: torch.randn((3,)) + torch.zeros(3).uniform_())
    assert _rules(findings) == {"global-generator"}
    assert len(findings) == 2
    _assert_context(findings)


def test_explicit_generator_draws_clean():
    def good():
        g = _gen(0)
        torch.randn((3,), generator=g) + torch.zeros(3).uniform_(generator=g)
    assert _check(good) == []


# -- step-invariant-draw ------------------------------------------------------


def test_noise_drawn_once_outside_the_loop_flagged():
    def bad():
        g = _gen(0)
        fixed = torch.rand((K, M, H, A), generator=g)
        _drive(3, lambda t: _noise(g, gumbel=fixed))

    findings = _check(bad)
    assert _rules(findings) == {"step-invariant-draw"}
    assert "'gumbel'" in findings[0].message
    _assert_context(findings)


def test_noise_drawn_every_step_clean():
    def good():
        g = _gen(0)
        _drive(3, lambda t: _noise(g))
    assert _check(good) == []


# -- per-agent-fanout ---------------------------------------------------------


def test_one_agent_row_broadcast_flagged():
    def bad():
        g = _gen(0)
        _drive(2, lambda t: _noise(g, gumbel=torch.rand(
            (1, M, H, A), generator=g).expand(K, M, H, A)))

    findings = _check(bad)
    assert _rules(findings) == {"per-agent-fanout"}
    assert any("bit-equal" in f.message for f in findings)
    assert any("not one 4-wide draw" in f.message for f in findings)


def test_copied_agent_row_flagged():
    def bad():
        g = _gen(0)

        def noise(t):
            gumbel = torch.rand((K, M, H, A), generator=g)
            gumbel[2] = gumbel[0]
            return _noise(g, gumbel=gumbel)
        _drive(2, noise)

    findings = _check(bad)
    assert _rules(findings) == {"per-agent-fanout"}
    assert "agents 0 and 2" in findings[0].message


# -- the real entry points ----------------------------------------------------


@pytest.mark.parametrize("program", [
    "decbyzpg", "byzpg", "run_grid", "fed_train_window", "fed_train_step",
    "fed_train_step_flat"])
def test_real_entry_points_clean(program):
    assert run("cpu", selected=[program]) == []
