"""User-facing numerics API: potential/Hesse evaluation and AL-condition scans.

The port of ``inflatox_tpu/consistency_conditions.py`` (reference:
``python/inflatox/consistency_conditions.py`` plus the Rust grid scans it
calls).  A grid scan (the four analyses, ``calc_V_array``,
``calc_H_array``, ``flag_quantum_dif``) of a 2-field model is one launch of
a hand-written CUDA grid-scan kernel (:mod:`inflatox_torch.ops.cuda_kernels`)
on a CUDA device, or its plain PyTorch version on any device; an
on-trajectory scan (``*_ot``) is one launch of the same analysis at given
points, or its plain version.

Devices are explicit: ``GeneralisedAL(artifact, device=...)`` computes on
that device only.  ``engine=None`` resolves to ``"cuda"`` (the kernel) on a
CUDA device and to ``"torch"`` (the plain version) on a CPU device.
``precision`` picks the arithmetic, in the kernel and in its plain version
alike:

* ``None`` or ``"f64"`` — IEEE f64 (kernel B1 on grids, B5a on points): what
  the JAX package's ``"pallas_df64"`` and ``"pallas_edf64"`` emulate;
* ``"f32"`` — float32 (kernel B2), the JAX package's ``engine="pallas"``;
  grids only, as there.  ``dtype=float32`` is the JAX package's spelling;
* ``"dd"`` — the model functions in double-double (about 106 bits), demoted
  to f64 for the f64 analysis tail (kernel B4 on grids, B5b on points): the
  JAX package's ``"pallas_tf64"``, for models whose Hesse cancels
  catastrophically (EGNO, docs/numerics.md §8).

The ``threads`` keyword of the reference is accepted and ignored.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .compiler import CompiledModel
from .ops.cuda_kernels import PRECISIONS, scan_cuda, scan_points_cuda, scan_points_torch, scan_torch
from .ops.grid import grid_coords
from .utils.devices import resolve_device, resolve_engine, resolve_precision
from .utils.errors import BasisNormError, BasisOrthogonalityError, ShapeError
from .utils.logging import Progress, log_warn
from .utils.profiling import annotate

__all__ = ["InflationCondition", "GeneralisedAL"]

_DBL_MIN = 2.2250738585072014e-308


class InflationCondition:
    """Base class owning a compiled model; point evaluation of the potential
    and projected Hesse matrix, and basis validation.

    Reference parity: ``InflationCondition`` (consistency_conditions.py:31-196)
    + the pymethods it calls (lib.rs:309-463)."""

    def __init__(
        self,
        compiled_artifact: CompiledModel,
        device="cuda",
        validate_basis: bool = True,
        validation_seed: int | None = None,
    ):
        """Args mirror the reference (consistency_conditions.py:38-50), plus
        ``device``, where every computation of this object runs.  A CUDA
        device on a host without CUDA raises (pass ``device="cpu"``).

        When ``validate_basis`` is true the vielbein is checked for
        orthonormality at 100 random field-space points (x ∈ [-1,1)^d,
        params ∈ [-10,10)^k, tolerance 1e-3 — lib.rs:142-203); NaN results
        produce warnings, out-of-tolerance results raise.
        ``validation_seed`` fixes the random points (the same numpy draws as
        the JAX package for the same seed)."""
        self.artifact = compiled_artifact
        self.device = resolve_device(device)
        self.dtype = torch.float64
        if validate_basis:
            self._validate_basis_at_random(seed=validation_seed)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.float64), device=self.device)

    # ------------------------------------------------------------------ #
    # basis validation                                                   #
    # ------------------------------------------------------------------ #

    def _basis_inner_products(self, xs, p):
        """All pairwise basis inner products at the given points.

        Returns dict {(i, j): tensor} for i <= j."""
        m = self.artifact
        d = m.n_fields
        flat = m.basis_tuple(xs, p)
        vecs = [flat[i * d : (i + 1) * d] for i in range(d)]
        return {
            (i, j): m.inner_prod(xs, p, vecs[i], vecs[j])
            for i in range(d)
            for j in range(i, d)
        }

    #: per-component NaN warnings are capped (then summarized)
    _MAX_NAN_WARNINGS = 8

    #: points per basis-validation chunk (keeps reference-scale domains,
    #: 8000² samples, at tens of MB while preserving the point-major
    #: warn/raise order)
    _BASIS_CHUNK = 1 << 20

    def _check_basis_points(self, xs_np, p, accuracy: float) -> None:
        """Shared warn/raise logic of lib.rs:142-203 and lib.rs:205-307,
        in point chunks.  Raise order matches the reference's scan order
        (point-major, then (i, j) lexicographic): the first violation
        encountered raises."""
        flat = [np.ravel(np.asarray(c)) for c in xs_np]
        n_total = flat[0].shape[0]
        state = {"warned": 0, "suppressed": 0, "nan_points": 0}
        for lo in range(0, n_total, self._BASIS_CHUNK):
            sl = slice(lo, min(lo + self._BASIS_CHUNK, n_total))
            self._check_basis_chunk(
                tuple(c[sl] for c in flat), p, accuracy, state
            )
        if state["suppressed"]:
            log_warn(
                f"(+{state['suppressed']} further NaN basis inner products "
                "suppressed)"
            )
        if state["nan_points"]:
            log_warn(
                f"Inflatox was unable to verify basis orthonormality at "
                f"{state['nan_points']} out of {n_total} tested points.\n"
                f"This could be indicative of a defective model.\nUsed "
                f"parameter values: p={list(np.asarray(p))}"
            )

    def _check_basis_chunk(self, xs_np, p, accuracy: float, state) -> None:
        d = self.artifact.n_fields
        xs = tuple(self._tensor(c) for c in xs_np)
        ips = self._basis_inner_products(xs, self._tensor(p))
        coords = [np.asarray(c) for c in xs_np]
        n = coords[0].shape[0]

        def point_at(idx):
            return [float(c[idx]) for c in coords]

        def host(value):
            if torch.is_tensor(value):
                value = value.cpu().numpy()
            return np.broadcast_to(np.asarray(value, dtype=np.float64), (n,))

        nan_any = np.zeros(n, dtype=bool)

        # pass 1: masks for every (i, j) pair + the first violation in the
        # reference's scan order (point-major, then (i, j) lexicographic)
        masks = {}
        first_violation = None  # (point_idx, i, j, value)
        for i in range(d):
            for j in range(i, d):
                arr = host(ips[(i, j)])
                normal = np.isfinite(arr) & (np.abs(arr) >= _DBL_MIN)
                if i == j:
                    nan_mask = ~normal
                    viol_mask = normal & (np.abs(arr - 1.0) >= accuracy)
                else:
                    nan_mask = ~normal & (arr != 0.0)
                    viol_mask = ~nan_mask & (np.abs(arr) >= accuracy)
                masks[(i, j)] = (arr, nan_mask)
                nan_any |= nan_mask
                if viol_mask.any():
                    idx = int(np.argmax(viol_mask))
                    cand = (idx, i, j, float(arr[idx]))
                    if first_violation is None or cand[:3] < first_violation[:3]:
                        first_violation = cand

        # pass 2: NaN warnings, emitted in scan order and only for entries
        # the reference would reach before raising (it warns as it scans)
        entries = sorted(
            (idx, i, j)
            for (i, j), (_, nan_mask) in masks.items()
            for idx in np.flatnonzero(nan_mask)
        )
        for idx, i, j in entries:
            if first_violation is not None and (idx, i, j) > first_violation[:3]:
                continue
            if state["warned"] >= self._MAX_NAN_WARNINGS:
                state["suppressed"] += 1
                continue
            state["warned"] += 1
            ip = float(masks[(i, j)][0][idx])
            if i == j:
                log_warn(
                    f"Norm of basisvector {i} is {ip} at "
                    f"field-space point {point_at(idx)}.\n"
                    "Are we outside the model's domain?"
                )
            else:
                log_warn(
                    f"w{i}•w{j} = {ip} at field-space point "
                    f"{point_at(idx)}.\nAre we outside the model's "
                    "domain?"
                )

        if first_violation is not None:
            idx, i, j, ip = first_violation
            if i == j:
                raise BasisNormError(ip, i, point_at(idx))
            raise BasisOrthogonalityError(ip, (i, j), point_at(idx))

        state["nan_points"] += int(nan_any.sum())

    def _validate_basis_at_random(
        self, num_points: int = 100, seed: int | None = None
    ) -> None:
        m = self.artifact
        rng = np.random.default_rng(seed)
        # distributions match lib.rs:144-161: params U[-10,10), x U[-1,1)
        p = 10.0 * (-1.0 + 2.0 * rng.random(m.n_parameters))
        xs = tuple(
            -1.0 + 2.0 * rng.random(num_points) for _ in range(m.n_fields)
        )
        self._check_basis_points(xs, p, accuracy=1e-3)

    def validate_basis_on_domain(
        self,
        args,
        start,
        stop,
        N=100,
        accuracy: float = 1e-3,
    ) -> None:
        """Check basis orthonormality on a full Cartesian grid over
        [start, stop] (N samples per axis; int N applies to every axis).

        Reference parity: consistency_conditions.py:158-196 / lib.rs:205-307,
        with the two reference bugs fixed as in the JAX package (the int-N
        check, and sampling from ``start``)."""
        d = self.artifact.n_fields
        if isinstance(N, (int, np.integer)):
            N = [int(N)] * d
        if len(N) != d or len(list(start)) != d or len(list(stop)) != d:
            raise ShapeError(
                (d,), (len(list(N)),),
                "expected start/stop/N with one entry per field-space coordinate",
            )
        self._validate_args(args)
        axes = [
            a + np.arange(n) * (b - a) / n for (a, b, n) in zip(start, stop, N)
        ]
        mesh = np.meshgrid(*axes, indexing="ij")
        self._check_basis_points(tuple(mesh), np.asarray(args, float), accuracy)

    # ------------------------------------------------------------------ #
    # argument validation (validiate_p, anguelova.rs:70-79)              #
    # ------------------------------------------------------------------ #

    def _validate_args(self, args) -> np.ndarray:
        args = np.asarray(args, dtype=float)
        if args.shape != (self.artifact.n_parameters,):
            raise ShapeError(
                (self.artifact.n_parameters,),
                args.shape,
                f'model "{self.artifact.model_name}" has '
                f"{self.artifact.n_parameters} parameters",
            )
        return args

    def _validate_2field(self) -> None:
        """The AL condition requires a 2-field model (anguelova.rs:55-65)."""
        if self.artifact.n_fields != 2:
            raise ShapeError(
                (2,),
                (self.artifact.n_fields,),
                "the Anguelova & Lazaroiu consistency condition requires a "
                "2-field model.",
            )

    def _validate_point(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=float)
        if x.shape != (self.artifact.n_fields,):
            raise ShapeError(
                (self.artifact.n_fields,), x.shape,
                "expected a 1D array with as many elements as there are "
                "field-space coordinates",
            )
        return x

    # ------------------------------------------------------------------ #
    # potential / Hesse evaluation                                       #
    # ------------------------------------------------------------------ #

    def calc_V(self, x, args) -> float:
        """Scalar potential at field-space point ``x``
        (consistency_conditions.py:52-65)."""
        args = self._validate_args(args)
        x = self._validate_point(x)
        v = self.artifact.potential(self._tensor(x), self._tensor(args))
        return float(v)

    def calc_H(self, x, args) -> np.ndarray:
        """Projected Hesse matrix at ``x``
        (consistency_conditions.py:103-117)."""
        args = self._validate_args(args)
        x = self._validate_point(x)
        h = self.artifact.hesse(self._tensor(x), self._tensor(args))
        return h.cpu().numpy()

    # ------------------------------------------------------------------ #
    # potential / Hesse grid surfaces                                    #
    # ------------------------------------------------------------------ #

    def _array_scan(self, kind, args, start, stop, N, engine, precision):
        """The V or Hesse surface on an endpoint-exclusive grid over
        [start, stop) with N samples per axis (default 8000): for a 2-field
        model one scan of the ``potential``/``hesse`` kind; for any other
        field count the plain f64 torch evaluation, which is also the JAX
        package's only path for those models (its ``"xla"`` branch).
        Returns the (n_out, *N) tensor on the device."""
        args = self._validate_args(args)
        d = self.artifact.n_fields
        N = [8000] * d if N is None else [int(n) for n in N]
        start_stop = [(float(a), float(b)) for a, b in zip(start, stop)]
        if len(start_stop) != d or len(N) != d:
            raise ShapeError(
                (d,), (len(start_stop),),
                "expected start/stop/N with one entry per field-space coordinate",
            )
        precision = resolve_precision(precision)
        if d == 2:
            engine = resolve_engine(engine, self.device, f"kernel {PRECISIONS[precision].grid_kernel}")
            scan = scan_cuda if engine == "cuda" else scan_torch
            extent = (*start_stop[0], *start_stop[1])
            return scan(self.artifact, kind, args, extent, N, self.device, precision)
        if engine == "cuda" or precision != "f64":
            raise ValueError(
                f"the grid-scan kernels take 2-field models; this model has {d} "
                'fields, which the plain f64 version computes (engine=None or "torch", '
                'precision=None or "f64")'
            )
        resolve_engine(engine, self.device, "no kernel")
        xs = grid_coords(start_stop, N, self.device)
        p = self._tensor(args)
        if kind == "potential":
            v = self.artifact.potential(xs, p)
            return torch.as_tensor(v, dtype=torch.float64, device=self.device).expand(N)[None]
        return self.artifact.hesse(xs, p).reshape(d * d, *N)

    def calc_V_array(self, args, start, stop, N=None, engine=None, precision=None) -> np.ndarray:
        """Potential sampled on an n-D grid (endpoint-exclusive, see
        :mod:`inflatox_torch.ops.grid`), default 8000 samples per axis
        (consistency_conditions.py:67-101).  ``engine`` and ``precision`` as
        in :meth:`GeneralisedAL.complete_analysis`, for a 2-field model
        (kernel B1, B2 or B4 with the ``potential`` kind); any other field
        count runs the plain f64 version.  Returns a numpy array (float32
        for ``precision="f32"``)."""
        out = self._array_scan("potential", args, start, stop, N, engine, precision)
        return out[0].cpu().numpy()

    def calc_H_array(self, args, x0_start, x0_stop, x1_start, x1_stop, N=None,
                     engine=None, precision=None) -> np.ndarray:
        """Projected Hesse matrix on a 2-D grid → shape (2, 2, N0, N1)
        (consistency_conditions.py:119-156); :meth:`calc_H_array_nd` takes
        any field count."""
        self._validate_2field()
        N = [8000, 8000] if N is None else [int(n) for n in N]
        return self.calc_H_array_nd(args, [x0_start, x1_start], [x0_stop, x1_stop], N,
                                    engine=engine, precision=precision)

    def calc_H_array_nd(self, args, start, stop, N=None, engine=None,
                        precision=None) -> np.ndarray:
        """Projected Hesse matrix on an n-D grid → shape (d, d, *N), the
        n-field grid evaluation of the reference's ``Hesse::hesse_array``
        (hesse_bindings.rs:113-193).  ``engine`` and ``precision`` as in
        :meth:`calc_V_array` (kernel: the ``hesse`` kind)."""
        out = self._array_scan("hesse", args, start, stop, N, engine, precision)
        d = self.artifact.n_fields
        return out.reshape(d, d, *out.shape[1:]).cpu().numpy()


_SCAN_MESSAGES = {
    "complete_analysis": "Calculating full analysis",
    "consistency": "Calculating consistency condition ONLY",
    "consistency_rapidturn": (
        "Calculating consistency condition ONLY assuming rapid-turn"
    ),
    "epsilon_v": "Calculating potential slow-roll parameter ε_V ONLY",
    "gradient": "Calculating raw potential gradient",
    "complete_analysis_ot": "Calculating full analysis on trajectory",
    "consistency_ot": "Calculating consistency condition ONLY on trajectory",
    "consistency_rapidturn_ot": (
        "Calculating consistency condition (rapid turn approx.) ONLY on "
        "trajectory"
    ),
    "epsilon_v_ot": (
        "Calculating potential slow-roll parameter ε_V ONLY on trajectory"
    ),
}


class GeneralisedAL(InflationCondition):
    """Generalised rapid-turn (ω ≫ ε^½) AL consistency condition
    (arXiv:2405.11628) and related slow-roll quantities; also the original
    rapid-turn limit (arXiv:2210.00031v2).

    Reference parity: ``GeneralisedAL`` (consistency_conditions.py:199-715).
    """

    def _grid_scan(self, kind, args, extent, shape, progress, threads, dtype,
                   engine, output, precision):
        """Shared body of the grid scans: the (n_out, N0, N1) result as
        ``output`` asks (single-output kinds return their one map,
        complete_analysis all six)."""
        del threads
        if output not in ("f64", "f64_device", "pair"):
            raise ValueError(
                f"output must be 'f64', 'f64_device' or 'pair', got {output!r}"
            )
        precision = resolve_precision(precision, dtype)
        if output == "pair" and precision == "f32":
            raise ValueError(
                'output="pair" needs precision "f64" or "dd": the f32 scan has no '
                "(hi, lo) representation to expose"
            )
        out = self._scan(kind, args, extent, shape, progress, engine, precision, output)
        if output == "pair":
            hi = out.float()
            lo = (out - hi.double()).float()
            out = [(hi[k], lo[k]) for k in range(out.shape[0])]
        if kind != "complete_analysis":
            return out[0]
        return tuple(out[k] for k in range(len(out)))

    def _scan(self, kind, args, extent, shape, progress, engine, precision, output="f64"):
        """One grid scan on the device (kernel or plain version); a numpy
        array for ``output="f64"``, else the tensor on the device.  Spans:
        ``inflx.scan.launch`` (checks, library lookup, enqueue) and
        ``inflx.scan.deliver`` (the wait, the numpy allocation and the
        copy)."""
        with contextlib.ExitStack() as reporting:
            with annotate("inflx.scan.launch"):
                engine = resolve_engine(engine, self.device,
                                        f"kernel {PRECISIONS[precision].grid_kernel}")
                self._validate_2field()
                args = self._validate_args(args)
                scan = scan_cuda if engine == "cuda" else scan_torch
                reporting.enter_context(Progress(_SCAN_MESSAGES[kind], enabled=progress,
                                                 total_ops=int(shape[0]) * int(shape[1])))
                out = scan(self.artifact, kind, args, extent, shape, self.device, precision)
            if output == "f64":
                with annotate("inflx.scan.deliver"):
                    out = out.cpu().numpy()
            elif progress and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # honest finish time
        return out

    def complete_analysis(
        self,
        args,
        x0_start: float,
        x0_stop: float,
        x1_start: float,
        x1_stop: float,
        N_x0: int = 1_000,
        N_x1: int = 1_000,
        progress: bool = True,
        threads: int | None = None,
        dtype=None,
        engine: str | None = None,
        output: str = "f64",
        precision: str | None = None,
    ):
        """Complete AL analysis over a field-space grid: returns six
        (N_x0, N_x1) maps — consistency, ε_V, ε_H, η_∥, δ, ω — exactly the
        quantities of anguelova.rs:103-135 (see ops.anguelova for the parity
        notes).  ``threads`` is accepted for compatibility and ignored.

        ``output``:
          * ``"f64"`` — numpy arrays (the reference's format; float32 for
            ``precision="f32"``, as the JAX package's ``engine="pallas"``);
          * ``"f64_device"`` — tensors left on the device;
          * ``"pair"`` — per quantity a ``(hi, lo)`` pair of float32 tensors
            on the device, ``hi = f32(v)``, ``lo = f32(v − hi)`` (what the
            JAX package's compensated engines return off the TPU); not for
            ``precision="f32"``.

        ``engine``:
          * None (default) — ``"cuda"`` on a CUDA device, ``"torch"`` on a
            CPU device;
          * ``"cuda"`` — the hand-written CUDA grid scan of ``precision``
            (kernel B1, B2 or B4);
          * ``"torch"`` — the plain PyTorch version at the same precision,
            on any device.

        ``precision``: None or ``"f64"``, ``"f32"``, ``"dd"`` (see the
        module's docstring).  ``dtype``: None, float64, or float32 (the JAX
        package's spelling of ``precision="f32"``); a ``dtype`` that
        contradicts ``precision`` raises.
        """
        return self._grid_scan(
            "complete_analysis", args, (x0_start, x0_stop, x1_start, x1_stop),
            (N_x0, N_x1), progress, threads, dtype, engine, output, precision,
        )

    def consistency(
        self,
        args,
        x0_start: float,
        x0_stop: float,
        x1_start: float,
        x1_stop: float,
        N_x0: int = 1_000,
        N_x1: int = 1_000,
        progress: bool = True,
        threads: int | None = None,
        dtype=None,
        engine: str | None = None,
        output: str = "f64",
        precision: str | None = None,
    ):
        """Generalised consistency condition ||lhs|−|rhs||/(|lhs|+|rhs|) with
        lhs = V_ww/V − 3 (consistency_conditions.py:310-365)."""
        return self._grid_scan(
            "consistency", args, (x0_start, x0_stop, x1_start, x1_stop),
            (N_x0, N_x1), progress, threads, dtype, engine, output, precision,
        )

    def epsilon_v(
        self,
        args,
        x0_start: float,
        x0_stop: float,
        x1_start: float,
        x1_stop: float,
        N_x0: int = 1_000,
        N_x1: int = 1_000,
        progress: bool = True,
        threads: int | None = None,
        dtype=None,
        engine: str | None = None,
        output: str = "f64",
        precision: str | None = None,
    ):
        """ε_V = ½(∇V/V)² (consistency_conditions.py:367-418)."""
        return self._grid_scan(
            "epsilon_v", args, (x0_start, x0_stop, x1_start, x1_stop),
            (N_x0, N_x1), progress, threads, dtype, engine, output, precision,
        )

    def consistency_rapidturn(
        self,
        args,
        x0_start: float,
        x0_stop: float,
        x1_start: float,
        x1_stop: float,
        N_x0: int = 1_000,
        N_x1: int = 1_000,
        progress: bool = True,
        threads: int | None = None,
        dtype=None,
        engine: str | None = None,
        output: str = "f64",
        precision: str | None = None,
    ):
        """Original AL rapid-turn condition
        (consistency_conditions.py:420-475)."""
        return self._grid_scan(
            "consistency_rapidturn", args,
            (x0_start, x0_stop, x1_start, x1_stop), (N_x0, N_x1),
            progress, threads, dtype, engine, output, precision,
        )

    def flag_quantum_dif(
        self,
        args,
        x0_start: float,
        x0_stop: float,
        x1_start: float,
        x1_stop: float,
        N_x0: int = 10_000,
        N_x1: int = 10_000,
        progress: bool = True,
        accuracy: float = 1e-3,
        dtype=None,
        engine: str | None = None,
        precision: str | None = None,
    ) -> np.ndarray:
        """Boolean mask of candidate saddle points: True where every raw
        gradient component satisfies |∂_a V| ≤ accuracy (the documented
        behaviour of consistency_conditions.py:477-523, as the JAX package
        implements it).  One grid scan of the ``gradient`` kind (kernel B1,
        B2 or B4 by ``precision``), thresholded on the device; a numpy bool
        array comes back.  ``engine``, ``precision`` and ``dtype`` as in
        :meth:`complete_analysis`."""
        precision = resolve_precision(precision, dtype)
        grads = self._scan("gradient", args, (x0_start, x0_stop, x1_start, x1_stop),
                           (N_x0, N_x1), progress, engine, precision, output="f64_device")
        return (grads.abs() <= accuracy).all(dim=0).cpu().numpy()

    # ---------------- on-trajectory variants --------------------------- #
    # (anguelova.rs:633-977: the same point ops over a user-supplied      #
    # (n, 2) trajectory array)                                            #

    def _run_trajectory_scan(self, kind, args, x, progress, engine, precision):
        """Shared body of the four ``*_ot`` methods: kernel B5a or B5b (or
        its plain version) at the points of ``x``; returns the (n_out, n)
        numpy result.  ``precision="f32"`` is not offered, as in the JAX
        package (consistency_conditions.py:1111-1113)."""
        self._validate_2field()
        args = self._validate_args(args)
        precision = resolve_precision(precision)
        if PRECISIONS[precision].point_kernel is None:
            raise ValueError(
                'the on-trajectory scans take precision None, "f64" or "dd" (the '
                "JAX package offers no f32 engine on trajectories)"
            )
        engine = resolve_engine(engine, self.device, f"kernel {PRECISIONS[precision].point_kernel}")
        if not torch.is_tensor(x):
            x = np.asarray(x, dtype=float)
        if x.ndim != 2 or x.shape[1] != self.artifact.n_fields:
            raise ShapeError(
                (-1, self.artifact.n_fields), tuple(x.shape),
                "trajectory must be an (n, n_fields) array of field-space "
                "points",
            )
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        scan = scan_points_cuda if engine == "cuda" else scan_points_torch
        with Progress(_SCAN_MESSAGES[kind], enabled=progress,
                      total_ops=int(x.shape[0])):
            out = scan(self.artifact, kind[: -len("_ot")], args, x, precision).cpu().numpy()
        return out

    def complete_analysis_ot(
        self, args, x, progress: bool = True, threads: int | None = None,
        engine: str | None = None, precision: str | None = None,
    ):
        """Complete analysis on an (n, 2) trajectory (a numpy array, or a
        float64 tensor) → list of six (n, 1) numpy arrays, consistency,
        ε_V, ε_H, η_∥, δ, ω (the reference returns ``np.split(out, 6, 1)``
        of an (n, 6) array, consistency_conditions.py:582-589).
        ``engine`` as in :meth:`complete_analysis` (``"cuda"``: kernel B5a,
        or B5b for ``precision="dd"``); ``precision`` None, ``"f64"`` or
        ``"dd"``."""
        del threads
        out = self._run_trajectory_scan("complete_analysis_ot", args, x, progress, engine,
                                        precision)
        return [o[:, None] for o in out]

    def consistency_ot(
        self, args, x, progress: bool = True, threads: int | None = None,
        engine: str | None = None, precision: str | None = None,
    ) -> np.ndarray:
        """:meth:`consistency` at the points of an (n, 2) trajectory → (n,)."""
        del threads
        return self._run_trajectory_scan("consistency_ot", args, x, progress, engine, precision)[0]

    def consistency_rapidturn_ot(
        self, args, x, progress: bool = True, threads: int | None = None,
        engine: str | None = None, precision: str | None = None,
    ) -> np.ndarray:
        """:meth:`consistency_rapidturn` at the points of an (n, 2)
        trajectory → (n,)."""
        del threads
        return self._run_trajectory_scan(
            "consistency_rapidturn_ot", args, x, progress, engine, precision
        )[0]

    def epsilon_v_ot(
        self, args, x, progress: bool = True, threads: int | None = None,
        engine: str | None = None, precision: str | None = None,
    ) -> np.ndarray:
        """:meth:`epsilon_v` at the points of an (n, 2) trajectory → (n,)."""
        del threads
        return self._run_trajectory_scan("epsilon_v_ot", args, x, progress, engine, precision)[0]
