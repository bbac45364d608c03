"""repro_torch.sweep — windowed, resumable, multi-process sweep service:
the port of the JAX package's ``repro.sweep``.

:class:`SweepRunner` drives :class:`repro_torch.Experiment`-shaped
scenario grids as long-running jobs: T cut into windows through the
algorithms' explicit-carry windows (bit-identical to the one-shot run),
per-window checkpoints (carries and generator states) + a sweep manifest
under ``out_dir`` for kill-and-resume, a group's rows spread over the
processes of a gloo process group (or whole groups sharded over them),
and partial summaries streamed through ``repro_torch.obs`` sinks. CLI:
``python -m repro_torch.launch.sweep``.
"""
from repro_torch.sweep.manifest import (MANIFEST, SUMMARY, GroupPaths,
                                        SweepMismatch, build_manifest,
                                        check_manifest, commit_window,
                                        read_json, windows_done, write_json)
from repro_torch.sweep.runner import SweepError, SweepRunner

__all__ = [
    "SweepRunner", "SweepError", "SweepMismatch",
    "MANIFEST", "SUMMARY", "GroupPaths",
    "build_manifest", "check_manifest", "commit_window", "windows_done",
    "read_json", "write_json",
]
