"""Per-run manifest: the static facts a telemetry stream needs to be read
after the fact (the port of the JAX package's ``repro/obs/manifest.py``):
versions, the backend and its devices, and the kernels' launch counts,
which show whether a run went through the CUDA kernels (the reference
records its backend-dispatch counters there).
"""
from __future__ import annotations

import json
import time
from typing import Optional

import torch


def build_manifest(extra: Optional[dict] = None) -> dict:
    """Snapshot the run environment. ``extra`` merges caller-provided
    facts (spec strings, CLI args)."""
    from repro_torch.kernels import dispatch
    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 0
    m = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
        "kernel_launch_counts": dict(sorted(
            dispatch.launch_counts().items())),
    }
    if extra:
        m.update(extra)
    return m


def write_manifest(path: str, extra: Optional[dict] = None) -> dict:
    doc = build_manifest(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return doc
