"""Build and load the port's CUDA kernels.

``csrc/aggregation.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/``
beside this file (listed in ``.gitignore``). The library's name carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. It is loaded with :mod:`ctypes`; every
pointer and the stream pass as ``c_void_p``.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "aggregation.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: largest stack (K) the kernels take: their register and shared-memory
#: arrays are sized for it (``KMAX`` in ``csrc/aggregation.cu``)
KMAX = 32

_VP, _INT, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
_SIGNATURES = {
    "repro_gram_f32": (_VP, _VP, _INT, _INT, _I64, _VP),
    "repro_weiszfeld_f32": (_VP, _VP, _INT, _INT, _F32, _INT, _VP),
    "repro_wsum_f32": (_VP, _VP, _VP, _INT, _INT, _I64, _VP),
    "repro_trimmed_mean_f32": (_VP, _VP, _INT, _INT, _I64, _INT, _VP),
    "repro_gossip_reduce_f32": (_VP, _VP, _VP, _INT, _INT, _I64, _INT, _INT,
                                _VP),
    "repro_neighbor_reduce_f32": (_VP, _VP, _INT, _INT, _I64, _INT, _INT,
                                  _VP),
    "repro_krum_score_f32": (_VP, _VP, _I64, _INT, _INT, _VP),
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


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libaggregation-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library for it exists; return its path."""
    out = library_path()
    if out.is_file():
        BUILD_INFO.update(seconds=0.0, ptxas="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)       # atomic: a concurrent loader sees all
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      ptxas=proc.stderr.strip())
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
