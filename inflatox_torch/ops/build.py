"""Build the hand-written kernels with nvcc and load them with ctypes.

Two libraries, each built per model from its sources in
``inflatox_torch/csrc`` plus one generated per-model header:

* the grid-scan library (``grid_scan.cu``, ``anguelova.cuh``, ``dd.cuh``
  and :meth:`~inflatox_torch.compiler.CompiledModel.cuda_source`), one per
  (model, precision), 2-field models: kernels B1, B7a and B5a in f64, B2
  and B7b in f32, B4, B7d and B5b in double-double;
* the solver library (``solver.cu``, ``solver.cuh``, ``survey.cuh`` and
  :meth:`~inflatox_torch.compiler.CompiledModel.cuda_solver_source`):
  kernel B6 and the survey's reduction of its rows, kernel B9, any field
  count.

Both include ``special.cuh`` (kernel B8, the special functions), which the
generated headers call; its sums and products are non-fusing intrinsics,
so it rounds alike under either library's flags.  A third library,
``special_eval.cu`` (one per checkout, no generated header), evaluates each
special function alone over a vector, for ``chip_smoke.py`` and the
card-only tests.

Each compiles into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas=-v
         -shared -Xcompiler -fPIC [-fmad=false] -I <gen dir> -I <csrc>
         -o libinflx_<name>.so <name>.cu

No ``--use_fast_math``.  The kernels and the generated headers repeat the
plain PyTorch versions' operations in their order, and no two of them may
be fused into an FMA, so each rounds as the corresponding torch kernel does
and the two agree to the last bit where they share a libm.  The libraries
get there two ways:

* grid scan: plain operators, built with ``-fmad=false``, in every
  precision; the double-double arithmetic (``dd.cuh``) writes its sums and
  products as non-fusing intrinsics besides, and its TwoProd as
  ``__fma_rn``, which ``-fmad=false`` leaves as it is;
* solver: sums and products through ``csrc/inflx_math.cuh``
  (``__dadd_rn``/``__dsub_rn``/``__dmul_rn``, never fused), built with
  nvcc's default contraction, so that CUDA's ``pow`` — one call in every
  attempt — compiles as it does inside ``torch.pow``.  With ``-fmad=false``
  it differs from ``torch.pow`` in a few of 16.8 million inputs
  (``scripts/probe_torch_pow_fmad.py``), and one trajectory in 4096 then
  parted from the plain version at cfg5d.  The grid scan keeps plain
  operators: the intrinsics made kernel B1 34 % slower (PERF.md).  A library
goes to ``build/inflatox_torch_kernels/<sha256>/`` under the checkout, keyed
by its sources, the generated header and the flags, and is built at first
use; ptxas's report (registers, spills) is kept beside it in ``nvcc.log``.
nvcc is found through ``CUDA_HOME`` (default ``/usr/local/cuda``) or
``PATH``.  A missing nvcc or a failed build raises; there is no fallback.
Different libraries build concurrently from different threads, so a caller
that needs several (several models or precisions) starts them together;
each library's build seconds are kept as ``build_seconds`` on it (about 0
when it was found built).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from ..utils.profiling import annotate

__all__ = ["BUILD_ROOT", "CSRC", "NVCC_FLAGS", "find_nvcc", "load_grid_scan",
           "load_solver", "load_special_eval"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "inflatox_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
_HEADER = "inflx_model.h"
_LOG = "nvcc.log"

_loaded: dict = {}  # (library, generated header) → loaded library
_locks: dict = {}  # (library, generated header) → its build lock
_locks_lock = threading.Lock()


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
        "PATH): the CUDA toolkit is needed to build the kernels"
    )


def _digest(spec, header_src: str) -> str:
    h = hashlib.sha256()
    for name in spec.sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(header_src.encode())
    h.update(" ".join(NVCC_FLAGS + spec.flags).encode())
    return h.hexdigest()


def _bind_grid_scan(lib: ctypes.CDLL) -> None:
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
    lib.inflx_grid_scan_batch.argtypes = [
        ctypes.c_int,       # kind
        ctypes.c_void_p,    # params, (S, n_params) (device)
        ctypes.c_void_p,    # out, (S, n_out, n0, n1) (device)
        ctypes.c_double,    # x0a
        ctypes.c_double,    # dx0
        ctypes.c_double,    # x1a
        ctypes.c_double,    # dx1
        ctypes.c_int64,     # n0
        ctypes.c_int64,     # n1
        ctypes.c_int64,     # S
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.inflx_grid_scan_batch.restype = ctypes.c_int
    lib.inflx_grid_scan_rows.argtypes = [
        ctypes.c_int,       # kind
        ctypes.c_void_p,    # params, (S, n_params) (device)
        ctypes.c_void_p,    # out, (S, n_out, n0, n1) (device)
        ctypes.c_double,    # x0a
        ctypes.c_double,    # dx0
        ctypes.c_double,    # x1a
        ctypes.c_double,    # dx1
        ctypes.c_int64,     # row0: the global index of the first row
        ctypes.c_int64,     # n0: rows scanned
        ctypes.c_int64,     # n1
        ctypes.c_int64,     # S
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.inflx_grid_scan_rows.restype = ctypes.c_int
    lib.inflx_max_sets.argtypes = []
    lib.inflx_max_sets.restype = ctypes.c_int64
    lib.inflx_points_scan.argtypes = [
        ctypes.c_int,       # kind
        ctypes.c_void_p,    # params (device)
        ctypes.c_void_p,    # points, (n, 2) f64 (device)
        ctypes.c_void_p,    # out (device)
        ctypes.c_int64,     # n
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.inflx_points_scan.restype = ctypes.c_int
    lib.inflx_points_scan_coherent.argtypes = [
        ctypes.c_int,       # kind
        ctypes.c_void_p,    # params (device)
        ctypes.c_void_p,    # points, (n, 2) f64 (device)
        ctypes.c_void_p,    # out (device)
        ctypes.c_int64,     # n
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.inflx_points_scan_coherent.restype = ctypes.c_int
    lib.inflx_precision.argtypes = []
    lib.inflx_precision.restype = ctypes.c_int


def _bind_solver(lib: ctypes.CDLL) -> None:
    lib.inflx_solve.argtypes = [
        ctypes.c_int,       # method
        ctypes.c_void_p,    # fields0, (B, NF) f64 (device)
        ctypes.c_void_p,    # derivs0, (B, NF) f64 (device)
        ctypes.c_void_p,    # params (device)
        ctypes.c_int64,     # params stride per trajectory (0: shared)
        ctypes.c_void_p,    # out, (steps, 2 NF + 2, B) f64 (device)
        ctypes.c_int64,     # B
        ctypes.c_int64,     # steps
        ctypes.c_double,    # max_err
        ctypes.c_double,    # 1 / max_err
        ctypes.c_void_p,    # cudaStream_t
        ctypes.c_void_p,    # counts, (attempts, lane_attempts, rejects) u64 (device), or None
    ]
    lib.inflx_solve.restype = ctypes.c_int
    lib.inflx_survey_reduce.argtypes = [
        ctypes.c_void_p,    # rows, (steps, 2 NF + 2, B) f64 (device)
        ctypes.c_void_p,    # params (device)
        ctypes.c_int64,     # params stride per trajectory (0: shared)
        ctypes.c_int64,     # B
        ctypes.c_int64,     # steps
        ctypes.c_void_p,    # out, (B, NF + 3) f64 (device)
        ctypes.c_void_p,    # ended, (B,) bool (device)
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.inflx_survey_reduce.restype = ctypes.c_int
    lib.inflx_n_fields.argtypes = []
    lib.inflx_n_fields.restype = ctypes.c_int


def _bind_special_eval(lib: ctypes.CDLL) -> None:
    from .special_eval import INSTANCES  # noqa: PLC0415

    for name in INSTANCES:
        fn = getattr(lib, f"inflx_sf_{name}")
        fn.argtypes = [
            ctypes.c_int,       # f32
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # p0..p3
            ctypes.c_void_p,    # z (device)
            ctypes.c_void_p,    # out (device)
            ctypes.c_int64,     # n
            ctypes.c_void_p,    # cudaStream_t
        ]
        fn.restype = ctypes.c_int


@dataclass(frozen=True)
class _Library:
    what: str  # for messages
    main: str  # the .cu file nvcc compiles
    sources: tuple  # every file of csrc/ it includes, hashed into the key
    lib: str
    bind: Callable
    flags: tuple  # beyond NVCC_FLAGS


_GRID_SCAN = _Library("grid-scan", "grid_scan.cu",
                      ("grid_scan.cu", "anguelova.cuh", "dd.cuh", "special.cuh"),
                      "libinflx_grid_scan.so", _bind_grid_scan, ("-fmad=false",))
_SOLVER = _Library("solver", "solver.cu", ("solver.cu", "solver.cuh", "survey.cuh",
                                           "inflx_math.cuh", "special.cuh"),
                   "libinflx_solver.so", _bind_solver, ())
_SPECIAL_EVAL = _Library("special-function", "special_eval.cu", ("special_eval.cu", "special.cuh"),
                         "libinflx_special_eval.so", _bind_special_eval,
                         ("-fmad=false",))


def _compile(spec: _Library, out_dir: Path, header_src: str) -> None:
    nvcc = find_nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: two processes building the
    # same digest never see a half-written library
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=out_dir.parent))
    try:
        (tmp / _HEADER).write_text(header_src)
        cmd = [
            nvcc, *NVCC_FLAGS, *spec.flags, "-I", str(tmp), "-I", str(CSRC),
            "-o", str(tmp / spec.lib), str(CSRC / spec.main),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building the {spec.what} "
                f"kernels:\n{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        (tmp / _LOG).write_text(proc.stderr + proc.stdout)
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not (out_dir / spec.lib).is_file():  # lost a race to a good build?
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load(spec: _Library, header_src: str) -> ctypes.CDLL:
    key = (spec.lib, header_src)
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _locks_lock:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        lib = _loaded.get(key)
        if lib is None:
            out_dir = BUILD_ROOT / _digest(spec, header_src)
            start = time.perf_counter()
            if not (out_dir / spec.lib).is_file():
                with annotate("inflx.build"):
                    _compile(spec, out_dir, header_src)
            seconds = time.perf_counter() - start
            lib = ctypes.CDLL(str(out_dir / spec.lib))
            spec.bind(lib)
            lib.inflx_error_string.argtypes = [ctypes.c_int]
            lib.inflx_error_string.restype = ctypes.c_char_p
            lib.build_log = out_dir / _LOG
            lib.build_seconds = seconds
            _loaded[key] = lib
    return lib


def load_grid_scan(header_src: str) -> ctypes.CDLL:
    """The grid-scan library for one generated model header
    (:meth:`CompiledModel.cuda_source`, whose precision picks kernels B1 and
    B5a, B2, or B4 and B5b), built on first use and loaded once per process
    (later calls are one dict lookup)."""
    return _load(_GRID_SCAN, header_src)


def load_special_eval() -> ctypes.CDLL:
    """The special-function library (``csrc/special_eval.cu``: kernel B8
    alone, one entry per function instance), built on first use and loaded
    once per process."""
    return _load(_SPECIAL_EVAL, "")


def load_solver(header_src: str) -> ctypes.CDLL:
    """The solver library (kernels B6 and B9) for one generated model header
    (:meth:`CompiledModel.cuda_solver_source`), built on first use and
    loaded once per process."""
    return _load(_SOLVER, header_src)
