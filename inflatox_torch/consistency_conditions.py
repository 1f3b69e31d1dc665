"""User-facing numerics API: potential/Hesse evaluation and AL-condition scans.

The port of ``inflatox_tpu/consistency_conditions.py`` (reference:
``python/inflatox/consistency_conditions.py`` plus the Rust grid scans it
calls).  A grid scan is one launch of kernel B1, the hand-written CUDA grid
scan (:mod:`inflatox_torch.ops.cuda_kernels`), on a CUDA device, or its plain
PyTorch version on any device.

Devices are explicit: ``GeneralisedAL(artifact, device=...)`` computes on
that device only.  ``engine=None`` resolves to ``"cuda"`` (kernel B1) on a
CUDA device and to ``"torch"`` (the plain version) on a CPU device.  The
``threads`` keyword of the reference is accepted and ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from .compiler import CompiledModel
from .ops.cuda_kernels import scan_cuda, scan_torch
from .utils.errors import BasisNormError, BasisOrthogonalityError, ShapeError
from .utils.logging import Progress, log_warn

__all__ = ["InflationCondition", "GeneralisedAL"]

_DBL_MIN = 2.2250738585072014e-308


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available "
            "on this host; pass device=\"cpu\" to compute on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA or CPU device, got {device}")
    return device


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
        self.device = _resolve_device(device)
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


_SCAN_MESSAGES = {
    "complete_analysis": "Calculating full analysis",
    "consistency": "Calculating consistency condition ONLY",
    "consistency_rapidturn": (
        "Calculating consistency condition ONLY assuming rapid-turn"
    ),
    "epsilon_v": "Calculating potential slow-roll parameter ε_V ONLY",
}

#: JAX-package engines and what takes their place in the port
_ENGINE_MAP = (
    '"pallas_df64" and "pallas_edf64" map to kernel B1 (engine="cuda"), '
    '"pallas_tf64" to a double-double kernel (ROADMAP B4), "pallas" to an '
    'f32 kernel (ROADMAP B2); "xla" has no counterpart — use engine="torch" '
    "for the plain PyTorch version"
)


class GeneralisedAL(InflationCondition):
    """Generalised rapid-turn (ω ≫ ε^½) AL consistency condition
    (arXiv:2405.11628) and related slow-roll quantities; also the original
    rapid-turn limit (arXiv:2210.00031v2).

    Reference parity: ``GeneralisedAL`` (consistency_conditions.py:199-715).
    """

    def _resolve_engine(self, engine):
        """``None`` → ``"cuda"`` on a CUDA device, ``"torch"`` on a CPU
        device.  ``"cuda"`` needs a CUDA device; ``"torch"`` runs on any."""
        if engine is None:
            return "cuda" if self.device.type == "cuda" else "torch"
        if engine == "cuda":
            if self.device.type != "cuda":
                raise ValueError(
                    'engine="cuda" runs kernel B1 on a CUDA device; this '
                    f"object computes on {self.device} (construct it with "
                    'device="cuda", or use engine="torch")'
                )
            return engine
        if engine == "torch":
            return engine
        if engine == "xla" or str(engine).startswith("pallas"):
            raise ValueError(
                f"engine={engine!r} is a JAX-package engine; in the PyTorch "
                f"port {_ENGINE_MAP}"
            )
        raise ValueError(
            f'unknown engine {engine!r}; expected None (auto), "cuda" or "torch"'
        )

    def _grid_scan(self, kind, args, extent, shape, progress, threads, dtype,
                   engine, output):
        """Shared body of the four grid-scan methods.  Single-output kinds
        return their one map; complete_analysis returns all six."""
        del threads
        if dtype is not None and dtype not in (torch.float64, np.float64):
            raise NotImplementedError(
                f"dtype={dtype!r}: the port computes in float64 only; the "
                "f32 kernel is ROADMAP B2"
            )
        if output == "pair":
            raise NotImplementedError(
                'output="pair" is a TPU (hi, lo) format; the port delivers '
                '"f64" and "f64_device" (ROADMAP A6)'
            )
        if output not in ("f64", "f64_device"):
            raise ValueError(
                f"output must be 'f64' or 'f64_device', got {output!r}"
            )
        engine = self._resolve_engine(engine)
        self._validate_2field()
        args = self._validate_args(args)
        scan = scan_cuda if engine == "cuda" else scan_torch
        with Progress(_SCAN_MESSAGES[kind], enabled=progress,
                      total_ops=int(shape[0]) * int(shape[1])):
            out = scan(self.artifact, kind, args, extent, shape, self.device)
            if output == "f64":
                out = out.cpu().numpy()
            elif progress and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # honest finish time
        if kind != "complete_analysis":
            return out[0]
        return tuple(out[k] for k in range(out.shape[0]))

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
    ):
        """Complete AL analysis over a field-space grid: returns six
        (N_x0, N_x1) maps — consistency, ε_V, ε_H, η_∥, δ, ω — exactly the
        quantities of anguelova.rs:103-135 (see ops.anguelova for the parity
        notes).  ``threads`` is accepted for compatibility and ignored.

        ``output``:
          * ``"f64"`` — numpy float64 arrays (the reference's format);
          * ``"f64_device"`` — float64 tensors left on the device;
          * ``"pair"`` raises ``NotImplementedError`` (a TPU format).

        ``engine``:
          * None (default) — ``"cuda"`` on a CUDA device, ``"torch"`` on a
            CPU device;
          * ``"cuda"`` — kernel B1, the hand-written CUDA grid scan;
          * ``"torch"`` — the plain PyTorch version, on any device.

        ``dtype``: None or float64 (the f32 kernel is ROADMAP B2).
        """
        return self._grid_scan(
            "complete_analysis", args, (x0_start, x0_stop, x1_start, x1_stop),
            (N_x0, N_x1), progress, threads, dtype, engine, output,
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
    ):
        """Generalised consistency condition ||lhs|−|rhs||/(|lhs|+|rhs|) with
        lhs = V_ww/V − 3 (consistency_conditions.py:310-365)."""
        return self._grid_scan(
            "consistency", args, (x0_start, x0_stop, x1_start, x1_stop),
            (N_x0, N_x1), progress, threads, dtype, engine, output,
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
    ):
        """ε_V = ½(∇V/V)² (consistency_conditions.py:367-418)."""
        return self._grid_scan(
            "epsilon_v", args, (x0_start, x0_stop, x1_start, x1_stop),
            (N_x0, N_x1), progress, threads, dtype, engine, output,
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
    ):
        """Original AL rapid-turn condition
        (consistency_conditions.py:420-475)."""
        return self._grid_scan(
            "consistency_rapidturn", args,
            (x0_start, x0_stop, x1_start, x1_stop), (N_x0, N_x1),
            progress, threads, dtype, engine, output,
        )
