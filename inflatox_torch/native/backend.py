"""ctypes runtime for the port's native CPU backend.

The port's copy of ``inflatox_tpu/native/backend.py``, on the port's own
``InflationModel`` and ``SymbolRegistry``.  Compiles the generated C (see
codegen.py) with the system compiler (``cc -O3 -march=native -fopenmp
-shared``, the same flags as the JAX package's backend, so that with one
compiler on one host both give the same bits; the first of ``$CC``, ``cc``,
``gcc``, ``clang`` that builds OpenMP) and loads it via ctypes — no dlopen symbol-table
handshake (the reference's dylib.rs ABI): the exported driver set is fixed
and versioned with the package.

It runs no kernel.  In the port it is what it is in the JAX package: the
IEEE-f64 oracle the card's kernels are held to, and the CPU denominator of
their speed.  The reference achieves CPU parallelism with rayon over a
dlopen'd per-point FFI (5 calls/pixel, anguelova.rs:103-135); here each
scan is one C call and OpenMP parallelizes rows internally.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..lowering.registry import SymbolRegistry
from ..symbolic import InflationModel
from ..utils.errors import ShapeError
from ..utils.logging import log_info
from .codegen import generate_c_source

__all__ = ["NativeModel", "native_available"]

_CFLAGS = [
    "-march=native",
    "-fpic",
    "-shared",
    "-fopenmp",
    # NB: no value-changing fast-math flags (the reference passes
    # -fno-signed-zeros, compiler.py:307; we drop it): this backend is the
    # numerical ORACLE for cancellation-heavy parity checks, so IEEE f64
    # semantics must be exact.  -fno-math-errno only waives errno stores.
    "-fno-math-errno",
    "-std=c17",
]


# a parallel loop: what the drivers need of the compiler and its OpenMP runtime
_OPENMP_PROBE = """\
int inflx_probe(int n) {
  int s = 0;
#pragma omp parallel for reduction(+ : s)
  for (int i = 0; i < n; ++i) s += i;
  return s;
}
"""


def _builds_openmp(cc: str) -> bool:
    """Whether ``cc`` builds an OpenMP shared object with the backend's
    flags (a compiler driver without its OpenMP runtime files fails here)."""
    tmpdir = tempfile.mkdtemp(prefix="inflx_native_probe_")
    try:
        c_path = os.path.join(tmpdir, "probe.c")
        with open(c_path, "w") as f:
            f.write(_OPENMP_PROBE)
        cmd = [cc, c_path, "-o", os.path.join(tmpdir, "probe.so"), "-O1", *_CFLAGS]
        return subprocess.run(cmd, capture_output=True).returncode == 0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _find_cc() -> str | None:
    """The first of ``$CC``, ``cc``, ``gcc``, ``clang`` that builds an
    OpenMP shared object, or None.  Checked once a process: a ``$CC`` whose
    driver lacks the OpenMP runtime (``libgomp.spec``) is passed over for
    the next, where the JAX package's backend would fail to build."""
    tried = set()
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and cc not in tried and shutil.which(cc):
            tried.add(cc)
            if _builds_openmp(cc):
                return cc
    return None


def native_available() -> bool:
    return _find_cc() is not None


class NativeModel:
    """A 2-field model compiled to a native shared object.

    Mirrors the scan surface of :class:`GeneralisedAL` (grid convention,
    output layout, formulas) so results are directly comparable with the
    kernels' maps; the IEEE-f64 oracle and the benchmark baseline.
    """

    def __init__(
        self,
        model: InflationModel,
        registry: SymbolRegistry | None = None,
        silent: bool = True,
        keep_source: bool = False,
        opt: str = "-O3",
    ):
        """``opt``: optimization level; use "-O1" when the backend serves as
        a numerical oracle only (IEEE f64 results are identical — no
        fast-math flags are involved — but giant models compile much
        faster)."""
        if _find_cc() is None:
            raise RuntimeError("no C compiler found for the native backend")
        registry = registry or SymbolRegistry.from_model(model)
        self.model = model
        self.n_fields = model.dim
        self.n_parameters = registry.n_parameters
        self.symbol_dictionary = registry.symbol_dictionary
        self.cc = _find_cc()  # the compiler that built it

        src = generate_c_source(model, registry)
        tmpdir = tempfile.mkdtemp(prefix="inflx_native_")
        c_path = os.path.join(tmpdir, "model.c")
        so_path = os.path.join(tmpdir, "model.so")
        with open(c_path, "w") as f:
            f.write(src)
        cmd = [self.cc, c_path, "-o", so_path, str(opt), *_CFLAGS, "-lm"]
        if not silent:
            log_info(f"native backend: {' '.join(cmd)}")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native compile failed:\n{proc.stderr}\nsource kept at {c_path}"
            )
        if not keep_source:
            os.remove(c_path)
        self._so_path = so_path
        lib = ctypes.CDLL(so_path)
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.inflx_complete_analysis.argtypes = [
            dptr, dptr,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.inflx_complete_analysis_ot.argtypes = [
            dptr, dptr, dptr, ctypes.c_int64, ctypes.c_int,
        ]
        lib.inflx_potential_grid.argtypes = lib.inflx_complete_analysis.argtypes
        lib.inflx_complete_analysis_refstyle.argtypes = (
            lib.inflx_complete_analysis.argtypes
        )
        lib.inflx_point_eval.argtypes = [dptr, dptr, dptr]
        lib.inflx_grad.argtypes = [dptr, dptr, dptr]
        lib.inflx_eom_eval.argtypes = [dptr, dptr, dptr, dptr]
        lib.inflx_consistency_rapidturn_refstyle.argtypes = (
            lib.inflx_complete_analysis.argtypes
        )
        lib.inflx_solve_eom_rkf.argtypes = [
            dptr, dptr, dptr,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
        ]
        self._lib = lib

    def _p(self, arr):
        return np.ascontiguousarray(arr, dtype=np.float64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)
        )

    def _check_args(self, args) -> np.ndarray:
        args = np.ascontiguousarray(args, dtype=np.float64)
        if args.shape != (self.n_parameters,):
            raise ShapeError((self.n_parameters,), args.shape, "parameter array")
        return args

    # ---- scan surface ---------------------------------------------------- #

    def complete_analysis(
        self, args, x0_start, x0_stop, x1_start, x1_stop,
        N_x0: int = 1000, N_x1: int = 1000, threads: int = 0,
    ):
        """Six (N_x0, N_x1) maps; same convention as GeneralisedAL.
        ``threads=0`` uses the OpenMP default (all cores)."""
        args = self._check_args(args)
        out = np.empty((N_x0, N_x1, 6), dtype=np.float64)
        self._lib.inflx_complete_analysis(
            self._p(args), self._p(out),
            float(x0_start), float(x0_stop), float(x1_start), float(x1_stop),
            N_x0, N_x1, int(threads),
        )
        return tuple(out[:, :, k].copy() for k in range(6))

    def complete_analysis_refstyle(
        self, args, x0_start, x0_stop, x1_start, x1_stop,
        N_x0: int = 1000, N_x1: int = 1000, threads: int = 0,
    ):
        """Reference-architecture scan: 5 indirect function-pointer calls per
        pixel, mirroring the reference's dlopen'd-FFI cost structure
        (anguelova.rs:103-135).  Used for baseline measurement only."""
        args = self._check_args(args)
        out = np.empty((N_x0, N_x1, 6), dtype=np.float64)
        self._lib.inflx_complete_analysis_refstyle(
            self._p(args), self._p(out),
            float(x0_start), float(x0_stop), float(x1_start), float(x1_stop),
            N_x0, N_x1, int(threads),
        )
        return tuple(out[:, :, k].copy() for k in range(6))

    def complete_analysis_ot(self, args, x, threads: int = 0):
        args = self._check_args(args)
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.ndim != 2 or x.shape[1] != 2:
            raise ShapeError((-1, 2), x.shape, "trajectory array")
        out = np.empty((x.shape[0], 6), dtype=np.float64)
        self._lib.inflx_complete_analysis_ot(
            self._p(args), self._p(x), self._p(out), x.shape[0], int(threads)
        )
        return out

    def calc_V_grid(self, args, x0_start, x0_stop, x1_start, x1_stop, N_x0, N_x1, threads: int = 0):
        args = self._check_args(args)
        out = np.empty((N_x0, N_x1), dtype=np.float64)
        self._lib.inflx_potential_grid(
            self._p(args), self._p(out),
            float(x0_start), float(x0_stop), float(x1_start), float(x1_stop),
            N_x0, N_x1, int(threads),
        )
        return out

    def point_eval(self, x, args):
        """(V, h00, h01, h10, h11, |∇V|²) at one point."""
        args = self._check_args(args)
        x = np.ascontiguousarray(x, dtype=np.float64)
        out = np.empty(6, dtype=np.float64)
        self._lib.inflx_point_eval(self._p(x), self._p(args), self._p(out))
        return out

    def grad(self, x, args):
        args = self._check_args(args)
        out = np.empty(2, dtype=np.float64)
        self._lib.inflx_grad(self._p(np.asarray(x)), self._p(args), self._p(out))
        return out

    def eom_eval(self, x, xdot, args):
        """(eom0, eom1, H_constraint, Hdot) at one phase-space point."""
        args = self._check_args(args)
        out = np.empty(4, dtype=np.float64)
        self._lib.inflx_eom_eval(
            self._p(np.asarray(x)), self._p(np.asarray(xdot)), self._p(args), self._p(out)
        )
        return out

    def consistency_rapidturn_refstyle(
        self, args, x0_start, x0_stop, x1_start, x1_stop,
        N_x0: int = 1000, N_x1: int = 1000, threads: int = 0,
    ):
        """Reference-architecture rapid-turn scan (4 indirect calls per
        pixel, anguelova.rs:143-154) — BASELINE cfg3 measurement."""
        args = self._check_args(args)
        out = np.empty((N_x0, N_x1), dtype=np.float64)
        self._lib.inflx_consistency_rapidturn_refstyle(
            self._p(args), self._p(out),
            float(x0_start), float(x0_stop), float(x1_start), float(x1_stop),
            N_x0, N_x1, int(threads),
        )
        return out

    def solve_eom_rkf(self, args, inits, steps: int, max_err: float = 1e-6,
                      threads: int = 0):
        """Reference-style C RKF45 background solves: ``inits`` is
        (n_traj, 4) = (φ0, φ1, χ0, χ1); returns (n_traj, steps, 6) rows of
        (φ0, φ1, χ0, χ1, H, t) — the layout of
        :func:`inflatox_torch.background.solve_eom` with ``return_time``.
        Sequential per trajectory (the reference's solver is,
        background_solver.rs:283-295); OpenMP across trajectories.  The
        BASELINE cfg5b measurement engine and a CPU cross-check oracle."""
        args = self._check_args(args)
        inits = np.ascontiguousarray(inits, dtype=np.float64)
        if inits.ndim != 2 or inits.shape[1] != 4:
            raise ShapeError((-1, 4), inits.shape, "initial-conditions array")
        out = np.empty((inits.shape[0], int(steps), 6), dtype=np.float64)
        self._lib.inflx_solve_eom_rkf(
            self._p(args), self._p(inits), self._p(out),
            inits.shape[0], int(steps), float(max_err), int(threads),
        )
        return out
