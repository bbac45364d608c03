"""The port's config and build audit (``repro_torch.analysis.retrace``):
the hygiene rules fire on broken config fixtures and not on their clean
twins, ``build-once`` fires on a CPU build, a second load and a second
compile (counted through fakes of the build, which this machine cannot
run), and the registry's configs and the swept grid are clean."""

import dataclasses

import pytest
import torch

from repro_torch.analysis.retrace import (BuildWatch, audit_builds,
                                          audit_static, audit_static_config)
from repro_torch.core.registry import normalize_spec_fields
from repro_torch.kernels import _build


def _rules(findings):
    return {f.rule for f in findings}


@dataclasses.dataclass(frozen=True)
class _GoodCfg:
    seed: int = 0
    eta: float = 1e-2
    attack: object = "none"

    def __post_init__(self):
        normalize_spec_fields(self, ("attack",))


@dataclasses.dataclass(frozen=True)
class _UnhashableCfg:
    seed: int = 0
    hidden: list = dataclasses.field(default_factory=lambda: [16, 16])


@dataclasses.dataclass(frozen=True)
class _UnstableCfg:
    seed: int = 0
    tag: object = dataclasses.field(default_factory=object)


@dataclasses.dataclass(frozen=True)
class _NoDefaultCfg:
    seed: int
    eta: float


@dataclasses.dataclass(frozen=True)
class _SeededCfg:
    """A field derived from the seed at construction."""
    seed: int = 0
    stream: int = -1

    def __post_init__(self):
        if self.stream < 0:
            object.__setattr__(self, "stream", 7 * self.seed + 1)


@dataclasses.dataclass(frozen=True)
class _RawSpecCfg:
    """Spec fields kept as the strings they were given."""
    seed: int = 0
    attack: object = "none"


def test_unhashable_config_flagged():
    findings = audit_static_config("fixture", _UnhashableCfg)
    assert _rules(findings) == {"unhashable-static"}
    assert findings[0].line > 0 and findings[0].path.endswith(
        "test_torch_analysis_retrace.py")


def test_unstable_config_flagged():
    assert _rules(audit_static_config("fixture", _UnstableCfg)) == \
        {"unstable-static-key"}


def test_default_config_must_construct():
    assert _rules(audit_static_config("fixture", _NoDefaultCfg)) == \
        {"default-config"}


def test_seed_derived_field_flagged():
    assert _rules(audit_static_config("fixture", _SeededCfg)) == \
        {"seed-in-static-key"}


def test_unnormalized_spec_fields_flagged():
    findings = audit_static_config("fixture", _RawSpecCfg)
    assert _rules(findings) == {"spec-normalization"}
    assert "large_noise(sigma=10.0)" in findings[0].message


def test_clean_fixture_config():
    assert audit_static_config("fixture", _GoodCfg) == []


def test_registry_configs_clean():
    assert audit_static() == []


# -- build-once ---------------------------------------------------------------


@pytest.fixture
def fake_build(monkeypatch):
    """``_build.build`` and ``library`` replaced by fakes: ``compiles``
    holds the seconds each build call reports."""
    compiles = []

    def build():
        _build.BUILD_INFO["seconds"] = compiles.pop(0) if compiles else 0.0
        return "libfake.so"

    def library():
        _build._LIB = _build._LIB or object()
        return _build._LIB

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "library", library)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setitem(_build.BUILD_INFO, "seconds", 0.0)
    return compiles


def test_cpu_route_build_flagged(fake_build):
    with BuildWatch() as watch:
        _build.build()
    assert _rules(watch.findings("cpu", "fixture")) == {"build-once"}


def test_second_compile_and_second_load_flagged(fake_build):
    fake_build.extend([18.5, 17.9])
    with BuildWatch() as watch:
        _build.build()
        _build.library()
        _build.build()
        _build._LIB = None           # dropped, then loaded again
        _build.library()
    msgs = [f.message for f in watch.findings("cuda", "fixture")]
    assert any("nvcc ran 2 times" in m for m in msgs)
    assert any("loaded 2 time(s)" in m for m in msgs)


def test_one_compile_and_one_load_clean(fake_build):
    fake_build.extend([18.5])
    with BuildWatch() as watch:
        _build.build()               # the up-front build: nvcc runs
        _build.library()             # the first launch loads it
        _build.build()               # found built: 0.0 s
    assert watch.builds == [18.5, 0.0] and watch.loads == 1
    assert watch.findings("cuda", "fixture") == []


def test_swept_grid_builds_nothing_on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert audit_builds("cpu") == []
    finally:
        torch.set_num_threads(threads)
