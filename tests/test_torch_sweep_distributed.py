"""Multi-process sweeps of the port on the CPU: ``python -m
repro_torch.launch.sweep --device cpu`` in two processes over a gloo
process group must print the single process's summary lines, in
``span`` mode, in ``shard`` mode through a shared ``--out``, and when a
``span`` run stopped by ``--stop-after`` is resumed by one ``local``
process; a resume on another device type exits non-zero. The counterpart
of ``tests/test_sweep_distributed.py``."""
import os
import socket
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
#: every process's wall limit: a hung rank fails its test
TIMEOUT_S = 300

GRID_ARGS = ["--device", "cpu", "--algo", "decbyzpg",
             "--env", "cartpole(horizon=20)", "--T", "4", "--seeds", "3",
             "--windows", "2",
             "--axis", "eta=5e-3,5e-2", "--axis", "attack=none,sign_flip",
             "--set", "K=3", "--set", "n_byz=1",
             "--set", "N=4", "--set", "B=2", "--set", "kappa=1",
             "--set", "hidden=(4,)"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(extra, grid=True):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sweep",
         *(GRID_ARGS if grid else []), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs) -> list:
    """Each process's stdout; kills every process if one hangs."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _two(extra, mode):
    port = _free_port()
    flags = ["--mode", mode, "--processes", "2",
             "--coordinator", f"localhost:{port}", *extra]
    return _finish([_launch(flags + ["--process-id", str(i)])
                    for i in range(2)])


def _summary_lines(out: str) -> list:
    return sorted(ln for ln in out.splitlines() if "final_return" in ln)


@pytest.fixture(scope="module")
def single():
    lines = _summary_lines(_finish([_launch([])])[0])
    assert len(lines) == 4
    return lines


def test_two_process_span_matches_single_process(single):
    out0, out1 = _two([], "span")
    # every process returns the whole merged result
    assert _summary_lines(out0) == _summary_lines(out1) == single


def test_two_process_shard_matches_single_process(single, tmp_path):
    out0, out1 = _two(["--out", str(tmp_path / "sweep")], "shard")
    assert _summary_lines(out0) == _summary_lines(out1) == single
    assert (tmp_path / "sweep" / "summary.json").exists()


def test_span_stopped_then_resumed_by_one_local_process(single, tmp_path):
    out = str(tmp_path / "sweep")
    # 4 groups of 2 windows: stopped inside group 1
    paused = _two(["--out", out, "--stop-after", "3"], "span")
    assert all("sweep paused" in o and not _summary_lines(o)
               for o in paused)
    resumed, = _finish([_launch(["--device", "cpu", "--resume", out,
                                 "--mode", "local"], grid=False)])
    assert _summary_lines(resumed) == single


def test_cli_exits_nonzero_on_a_manifest_mismatch(tmp_path):
    """A resume on another device type fails the CLI (exit code 1) with the
    mismatch named, and changes nothing in the sweep directory."""
    out = str(tmp_path / "sweep")
    _finish([_launch(["--out", out, "--stop-after", "1"])])
    before = sorted(os.listdir(out))
    proc = _launch(["--resume", out, "--device", "meta"], grid=False)
    try:
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 1
    assert "SweepMismatch" in err and "meta.device: 'cpu' != 'meta'" in err
    assert sorted(os.listdir(out)) == before
