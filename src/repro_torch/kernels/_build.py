"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into an
object (``csrc/*.cuh`` are headers they share), one ``nvcc`` per source,
all started together, and the objects are linked into one shared library
with a plain C interface, at first use, into ``build/`` beside this file
(listed in ``.gitignore``). The library's name carries a hash of all the
sources, headers and flags, so an edited file is rebuilt and an unchanged
set is loaded as it is. It is loaded with
:mod:`ctypes`; every pointer and the stream pass as ``c_void_p``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``. A failed build raises; nothing falls back to
the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: largest stack (K) or neighbour count (P) the kernels take: their
#: register and shared-memory arrays are sized for it (the largest height
#: of ``gram`` and ``weiszfeld`` in ``csrc/aggregation.cu`` and of the rank
#: network in ``csrc/cw_reduce.cu``)
KMAX = 32

_VP, _INT, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
_SIGNATURES = {
    "repro_gram_f32": (_VP, _VP, _VP, _INT, _INT, _I64, _INT, _INT, _VP),
    "repro_weiszfeld_f32": (_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "repro_wsum_f32": (_VP, _VP, _VP, _INT, _INT, _I64, _VP),
    "repro_trimmed_mean_f32": (_VP, _VP, _INT, _INT, _I64, _INT, _INT, _VP),
    "repro_gossip_reduce_f32": (_VP, _VP, _VP, _INT, _INT, _I64, *(_INT,) * 3,
                                _VP),
    "repro_neighbor_reduce_f32": (_VP, _VP, _INT, _INT, _I64, *(_INT,) * 3,
                                  _VP),
    "repro_krum_score_f32": (_VP, _VP, _I64, _INT, _INT, _INT, _VP),
    "repro_flash_attention_f32": (_VP, _VP, _VP, _VP, *(_I64,) * 12,
                                  *(_INT,) * 8, _F32, _VP),
    "repro_flash_attention_shared_bytes": (_INT, _INT),
}

_LIB = None
#: what the last build reported: ``seconds`` (0.0 when a cached library
#: was loaded) and ``ptxas`` (registers, shared memory and spills)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def sources() -> list:
    """The kernel sources, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its
    path. The per-source compiles run in parallel; ``ptxas -v`` reports
    (registers, shared memory, spills) land in :data:`BUILD_INFO`."""
    out = library_path()
    if out.is_file():
        BUILD_INFO.update(seconds=0.0, ptxas="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources(), objs)]
        reports = []
        for src, proc in zip(sources(), procs):
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{stdout}\n"
                                   f"{stderr}")
            reports.append(stderr.strip())
        lib = Path(tmp) / out.name
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, out)       # atomic: a concurrent loader sees all
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      ptxas="\n".join(reports))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = (_INT,)
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(status: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        msg = library().repro_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{status}: {msg}")


class CFunction:
    """One C entry point of the library, looked up once at its first call
    (which builds the library). A call passes its arguments through and
    raises through :func:`check` when the returned status is not 0."""

    __slots__ = ("symbol", "name", "_fn")

    def __init__(self, symbol: str, name: str):
        self.symbol, self.name, self._fn = symbol, name, None

    def __call__(self, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library(), self.symbol)
        status = fn(*args)
        if status:
            check(status, self.name)
