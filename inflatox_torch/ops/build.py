"""Build the grid-scan kernel with nvcc and load it with ctypes.

The kernel sources (``inflatox_torch/csrc/grid_scan.cu`` and
``anguelova.cuh``) plus one generated per-model header
(:meth:`~inflatox_torch.compiler.CompiledModel.cuda_source`) compile into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -I <gen dir> -I <csrc>
         -o libinflx_grid_scan.so grid_scan.cu

No ``--use_fast_math``, and no FMA contraction (``-fmad=false``): the
generated header repeats the plain PyTorch version's operations in its
order, and each operation then rounds as the corresponding torch kernel
does, so the two agree to the last bit where they share a libm.  The
library goes to ``build/inflatox_torch_kernels/<sha256>/`` under the
checkout, keyed by the kernel sources, the generated header and the flags,
and is built at first use.  nvcc is found through ``CUDA_HOME`` (default
``/usr/local/cuda``) or ``PATH``.  A missing nvcc or a failed build raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["BUILD_ROOT", "CSRC", "NVCC_FLAGS", "find_nvcc", "load_grid_scan"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "inflatox_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
_SOURCES = ("grid_scan.cu", "anguelova.cuh")
_HEADER = "inflx_model.h"
_LIB = "libinflx_grid_scan.so"

_loaded: dict = {}  # generated header → loaded library
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA toolkit is needed to build the grid-scan kernel"
    )


def _digest(header_src: str) -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(header_src.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.inflx_grid_scan.argtypes = [
        ctypes.c_int,       # kind
        ctypes.c_void_p,    # params (device)
        ctypes.c_void_p,    # out (device)
        ctypes.c_double,    # x0a
        ctypes.c_double,    # dx0
        ctypes.c_double,    # x1a
        ctypes.c_double,    # dx1
        ctypes.c_int64,     # n0
        ctypes.c_int64,     # n1
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.inflx_grid_scan.restype = ctypes.c_int
    lib.inflx_error_string.argtypes = [ctypes.c_int]
    lib.inflx_error_string.restype = ctypes.c_char_p
    return lib


def _compile(out_dir: Path, header_src: str) -> None:
    nvcc = find_nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: two processes building the
    # same digest never see a half-written library
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=out_dir.parent))
    try:
        (tmp / _HEADER).write_text(header_src)
        cmd = [
            nvcc, *NVCC_FLAGS, "-I", str(tmp), "-I", str(CSRC),
            "-o", str(tmp / _LIB), str(CSRC / "grid_scan.cu"),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building the grid-scan "
                f"kernel:\n{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not (out_dir / _LIB).is_file():  # lost a race to a good build?
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_grid_scan(header_src: str) -> ctypes.CDLL:
    """The grid-scan library for one generated model header, built on first
    use and loaded once per process (later calls are one dict lookup)."""
    lib = _loaded.get(header_src)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(header_src)
        if lib is None:
            out_dir = BUILD_ROOT / _digest(header_src)
            if not (out_dir / _LIB).is_file():
                _compile(out_dir, header_src)
            lib = _loaded[header_src] = _bind(ctypes.CDLL(str(out_dir / _LIB)))
    return lib
