"""The port's lint (``repro_torch.analysis.lint``): every rule fires on a
seeded tmp-tree violation with file/line context and stays silent on its
clean twin, hatches suppress, README fences that import the port are
checked; the spec-string verdicts and the tracked-smoke findings equal
the reference's (exact: the same verdict per string, the same findings
per repo); the real tree and the CLI wiring are clean."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintConfig, check_tracked_smoke, run

REPO = Path(__file__).resolve().parents[1]


def _write(root: Path, rel: str, body: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(body))


def _lint(root: Path):
    return run(config=LintConfig(root=root))


def _one(findings, rule):
    hits = [f for f in findings if f.rule == rule]
    assert hits, f"no {rule} finding in {[f.format() for f in findings]}"
    return hits[0]


# -- spec-strings -------------------------------------------------------------


def test_unparseable_spec_flagged(tmp_path):
    _write(tmp_path, "src/repro_torch/foo.py", """\
        from repro_torch.core.registry import resolve

        def f():
            return resolve("aggregator", "rfa(((")
        """)
    f = _one(_lint(tmp_path), "spec-strings")
    assert f.path == "src/repro_torch/foo.py" and f.line == 4
    assert "rfa(((" in f.message


def test_unregistered_and_bad_kwarg_specs_flagged(tmp_path):
    _write(tmp_path, "chip_smoke.py",
           'CFG = dict(aggregator="definitely_not_registered")\n'
           'RUN = dict(attack="large_noise(bogus_kwarg=1)")\n')
    found = [f for f in _lint(tmp_path) if f.rule == "spec-strings"]
    assert [f.line for f in found] == [1, 2]
    assert "bogus_kwarg" in found[1].message


def test_valid_spec_clean_and_not_a_spec_hatch(tmp_path):
    _write(tmp_path, "tools/bench.py", """\
        CFG = dict(attack="large_noise(sigma=10)", aggregator="rfa")
        # analysis: not-a-spec
        LABELS = dict(attack="our strongest attack (sec 5)")
        """)
    assert _lint(tmp_path) == []


def test_doc_fence_importing_the_port_checked(tmp_path):
    _write(tmp_path, "README.md", """\
        # Demo

        ```python
        from repro_torch.core.registry import resolve
        agg = resolve("aggregator", "renamed_away")
        ```

        ```python
        from repro.core.registry import resolve
        agg = resolve("aggregator", "the reference's fence, not ours")
        ```
        """)
    found = _lint(tmp_path)
    f = _one(found, "spec-strings")
    # the line is offset into README.md; the reference's fence is skipped
    assert f.path == "README.md" and f.line == 5 and len(found) == 1


# the same verdict from the reference's resolver on its registry and the
# port's on its own: exact, string by string
SPECS = [
    ("rfa", ("aggregator",)),
    ("bucketing(inner=rfa(n_iter=64), s=2)", ("aggregator",)),
    ("bucketing(inner=nope, s=2)", ("aggregator",)),
    ("large_noise(sigma=10)", ("attack", "fed_attack")),
    ("large_noise(bogus=1)", ("attack", "fed_attack")),
    ("definitely_not_registered", ("aggregator", "fed_aggregator")),
    ("rfa(((", ("aggregator",)),
    ("cartpole(horizon=100)", ("env",)),
    ("transformer(arch='qwen2.5-3b')", ("policy",)),
    ("gda", ("agreement",)),
    ("adam(b1=0.9)", ("optimizer",)),
    ("ring(k=4)", ("topology",)),
    ("anything(x=1)", None),
    ("1 + 2", None),
]


@pytest.mark.parametrize("text,namespaces", SPECS)
def test_spec_verdicts_equal_the_reference(text, namespaces):
    ref = ref_lint._validate_spec(text, namespaces)
    port = lint._validate_spec(text, namespaces)
    assert (ref is None) == (port is None), (ref, port)


# -- global-generator ---------------------------------------------------------


def test_global_generator_draws_flagged(tmp_path):
    _write(tmp_path, "src/repro_torch/core/foo.py", """\
        import torch

        def f(x):
            a = torch.randn((3,))
            torch.manual_seed(0)
            return x.normal_() + a
        """)
    found = [f for f in _lint(tmp_path) if f.rule == "global-generator"]
    assert [f.line for f in found] == [4, 5, 6]


def test_explicit_generator_and_scripts_clean(tmp_path):
    _write(tmp_path, "src/repro_torch/core/foo.py", """\
        import torch

        def f(x, gen):
            gen.manual_seed(0)
            return x.normal_(generator=gen) + torch.randn(
                (3,), generator=gen)
        """)
    _write(tmp_path, "tools/bench.py", "import torch\nX = torch.randn(3)\n")
    _write(tmp_path, "tests/test_foo.py",
           "import torch\ntorch.manual_seed(0)\n")
    assert _lint(tmp_path) == []


# -- kernel-location ----------------------------------------------------------


def test_kernel_access_outside_kernels_flagged(tmp_path):
    _write(tmp_path, "src/repro_torch/core/foo.py", """\
        import ctypes

        LIB = ctypes.CDLL("libx.so")
        """)
    _write(tmp_path, "chip_smoke.py", """\
        from repro_torch.kernels import _build
        _build.library()
        """)
    _write(tmp_path, "tools/tri.py", """\
        import triton
        from torch.utils.cpp_extension import load

        @triton.jit
        def k(x):
            pass
        """)
    found = {(f.path, f.line) for f in _lint(tmp_path)
             if f.rule == "kernel-location"}
    assert found == {("src/repro_torch/core/foo.py", 3),
                     ("chip_smoke.py", 2), ("tools/tri.py", 2),
                     ("tools/tri.py", 4)}


def test_kernel_access_inside_kernels_and_build_clean(tmp_path):
    _write(tmp_path, "src/repro_torch/kernels/foo.py", """\
        import ctypes

        LIB = ctypes.CDLL("libx.so")
        """)
    _write(tmp_path, "chip_smoke.py", """\
        from repro_torch.kernels import _build
        _build.build()
        """)
    assert _lint(tmp_path) == []


# -- host-sync ----------------------------------------------------------------


def test_host_sync_in_hot_module_flagged(tmp_path):
    _write(tmp_path, "src/repro_torch/core/foo.py", """\
        def f(x):
            return x.sum().item()
        """)
    _write(tmp_path, "src/repro_torch/serving/engine.py", """\
        def tick(x):
            return x.cpu().numpy()
        """)
    found = sorted((f.path, f.line) for f in _lint(tmp_path)
                   if f.rule == "host-sync")
    assert found == [("src/repro_torch/core/foo.py", 2),
                     ("src/repro_torch/serving/engine.py", 2),
                     ("src/repro_torch/serving/engine.py", 2)]


def test_host_side_hatch_and_cold_modules_clean(tmp_path):
    _write(tmp_path, "src/repro_torch/core/foo.py", """\
        def f(x):
            # analysis: host-side (once per run)
            return x.sum().item()
        """)
    _write(tmp_path, "src/repro_torch/serving/server.py", """\
        def report(x):
            return x.tolist()
        """)
    assert _lint(tmp_path) == []


# -- reference-import ---------------------------------------------------------


def test_reference_imports_flagged(tmp_path):
    _write(tmp_path, "src/repro_torch/foo.py", """\
        import importlib
        import jax.numpy as jnp
        from repro.core import engine

        def f():
            return importlib.import_module("jax")
        """)
    found = [f.line for f in _lint(tmp_path) if f.rule == "reference-import"]
    assert found == [2, 3, 6]


def test_port_imports_and_tests_clean(tmp_path):
    _write(tmp_path, "tools/bench.py", """\
        import repro_torch
        from repro_torch.core import engine
        """)
    _write(tmp_path, "tests/test_parity.py", "import jax\nimport repro\n")
    assert _lint(tmp_path) == []


# -- deep-import --------------------------------------------------------------


def test_deep_import_of_public_names_flagged_in_examples(tmp_path):
    _write(tmp_path, "examples_torch/demo.py", """\
        from repro_torch.core.engine import Experiment, seed_generator
        from repro_torch.serving import serve, policy_params
        """)
    hits = [f for f in _lint(tmp_path) if f.rule == "deep-import"]
    assert [(f.path, f.line) for f in hits] == \
        [("examples_torch/demo.py", 1), ("examples_torch/demo.py", 2)]
    assert "['Experiment']" in hits[0].message
    assert "['serve']" in hits[1].message


def test_public_surface_imports_and_hatch_clean(tmp_path):
    """The clean twin: the same names through the surface, internal names
    from their submodules, and a deliberate deep import under the hatch."""
    _write(tmp_path, "examples_torch/demo.py", """\
        from repro_torch import Experiment, serve
        from repro_torch.core.engine import seed_generator
        from repro_torch.serving import policy_params
        # analysis: deep-import
        from repro_torch.core.engine import Experiment as E
        """)
    assert _lint(tmp_path) == []


@pytest.mark.parametrize("line", ["from repro_torch.convert import x\n",
                                  "import repro_torch.convert\n"])
def test_import_outside_the_namespaces_flagged_in_examples(tmp_path, line):
    """A module outside ``repro_torch._MODULES`` is not on the surface,
    whatever name it is asked for."""
    _write(tmp_path, "examples_torch/demo.py", line)
    _write(tmp_path, "examples_torch/hatched.py",
           "# analysis: deep-import\n" + line)
    hits = [f for f in _lint(tmp_path) if f.rule == "deep-import"]
    assert [(f.path, f.line) for f in hits] == [("examples_torch/demo.py", 1)]
    assert "'repro_torch.convert'" in hits[0].message


@pytest.mark.parametrize("rel", ["src/repro_torch/launch/x.py",
                                 "tools/bench.py", "examples/demo.py"])
def test_deep_import_is_examples_scoped(tmp_path, rel):
    """Library code, tools and the reference's own examples may import
    from the defining submodule, as the reference's rule leaves src/
    alone (tests/test_serving.py's deep-import test)."""
    _write(tmp_path, rel, "from repro_torch.core.engine import Experiment\n")
    assert [f for f in _lint(tmp_path) if f.rule == "deep-import"] == []


def test_deep_import_names_follow_the_reference_rule():
    """The rule's public names are the port's surface, a superset of the
    reference rule's (each name from the submodule that mirrors the
    reference's)."""
    port = lint.DeepImport._public_names()
    ref = ref_lint.DeepImport._public_names()
    assert {k: v.replace("repro_torch.", "repro.", 1)
            for k, v in port.items() if k in ref} == ref


def test_examples_in_scope_of_the_other_rules(tmp_path):
    _write(tmp_path, "examples_torch/demo.py", """\
        import jax
        from repro_torch import Experiment
        Experiment(aggregator="not_an_aggregator")
        """)
    found = {f.rule for f in _lint(tmp_path)}
    assert found == {"reference-import", "spec-strings"}


# -- tracked-smoke-file -------------------------------------------------------


def _git(root, *argv):
    subprocess.run(["git", *argv], cwd=root, check=True, capture_output=True)


def test_tracked_smoke_findings_equal_the_reference(tmp_path):
    _git(tmp_path, "init", "-q")
    _write(tmp_path, "benchmarks/bench_smoke.json", "{}\n")
    _write(tmp_path, "benchmarks/other_smoke.json", "{}\n")
    _git(tmp_path, "add", "benchmarks/bench_smoke.json")
    port = check_tracked_smoke(LintConfig(root=tmp_path))
    ref = ref_lint.check_tracked_smoke(ref_lint.LintConfig(root=tmp_path))
    assert [f.rule for f in port] == ["tracked-smoke-file"]
    assert [(f.rule, f.path, f.line) for f in port] == \
        [(f.rule, f.path, f.line) for f in ref]


# -- the real tree + CLI wiring -----------------------------------------------


def test_repo_is_clean():
    assert run() == []


def test_cli_exit_codes(monkeypatch, capsys):
    from repro_torch.analysis import __main__ as cli

    monkeypatch.setitem(
        cli.PASSES, "lint",
        lambda device: [Finding("lint", "fixture", "src/x.py", 3, "seeded")])
    assert cli.main(["--passes", "lint", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "src/x.py:3: [lint/fixture] seeded" in out

    monkeypatch.setitem(cli.PASSES, "lint", lambda device: [])
    assert cli.main(["--passes", "lint", "--device", "cpu"]) == 0


def test_cli_rejects_unknown_pass_and_defaults_to_cuda():
    from repro_torch.analysis import __main__ as cli
    with pytest.raises(SystemExit):
        cli.main(["--passes", "nope", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--passes", "lint"])


def test_cli_module_runs_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--passes",
         "lint,retrace", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "[analysis] lint      ok" in proc.stderr
    assert "[analysis] retrace   ok" in proc.stderr
