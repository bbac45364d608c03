"""``python -m repro_torch.launch.train`` on the CPU (``--device cpu
--reduced``): the windowed loop and ``--no-fused``, their telemetry
files, the checkpoint round trip, its flags against the reference CLI's,
and the refusal to run without a card unless the CPU is asked for."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.set_num_threads(2)

STEPS = 6
ARGS = ["--arch", "llama3.2-1b", "--reduced", "--agents", "4", "--byz",
        "1", "--attack", "large_noise(sigma=10)", "--steps", str(STEPS),
        "--window", "4", "--seq", "16", "--kappa", "1", "--device", "cpu"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("fused", [True, False])
def test_cli_runs_with_telemetry_and_a_checkpoint(tmp_path, fused):
    out, ckpt = tmp_path / "tele", tmp_path / "agent0.npz"
    argv = ARGS + ["--telemetry-out", str(out), "--profile", "--ckpt",
                   str(ckpt)] + ([] if fused else ["--no-fused"])
    state = train.main(argv)
    rows = [r for r in _records(out / "metrics.jsonl")
            if r["stream"] == "fed"]
    assert [r["step"] for r in rows] == list(range(STEPS))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["mode"] == ("fused" if fused else "legacy")
    assert manifest["steps"] == STEPS and manifest["K"] == 4
    trace = json.loads((out / "trace.json").read_text())
    name = "train.window" if fused else "train.step"
    assert sum(e["name"] == name for e in trace["traceEvents"]) == \
        (2 if fused else STEPS)
    agent0 = train._agent0(state.params)
    back = restore(agent0, str(ckpt), device="cpu")
    for (p, a), (q, b) in zip(tree_paths(agent0), tree_paths(back)):
        assert p == q and torch.equal(a, b)
    assert int(state.step) == STEPS


def test_fused_and_per_step_loops_take_the_same_steps():
    """The window and the per-step loop run the same protocol; with
    page_p 1 every coin is 1 and no attack draws noise, so the two runs
    are the same steps, bit for bit."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--agents", "3",
            "--steps", "3", "--window", "2", "--seq", "16", "--kappa", "1",
            "--page-p", "1.0", "--aggregator", "trimmed_mean", "--byz", "1",
            "--attack", "sign_flip", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # one thread: the CPU's sums in one order
    try:
        a = train.main(argv)
        b = train.main(argv + ["--no-fused"])
    finally:
        torch.set_num_threads(threads)
    for (_, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y)


def test_cli_flags_are_the_reference_flags():
    """Every flag of ``repro.launch.train`` with its default, plus
    ``--device``."""
    import ast
    import inspect
    import repro.launch.train as jtrain

    def flags(mod):
        tree = ast.parse(inspect.getsource(mod))
        out = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "attr", "") == "add_argument":
                kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
                out[node.args[0].value] = (kw.get("default"),
                                           kw.get("type"),
                                           kw.get("action"))
        return out

    ours, ref = flags(train), flags(jtrain)
    assert set(ours) == set(ref) | {"--device"}
    assert {k: ours[k] for k in ref} == ref


def test_cli_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])


def test_cli_module_runs(tmp_path):
    """A fresh process, as a user launches it."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--agents", "2", "--steps", "2", "--window", "2", "--seq", "8",
         "--kappa", "1", "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "step    1" in out.stdout
