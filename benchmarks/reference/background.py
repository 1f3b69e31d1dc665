"""Plain reference of inflatox's background survey
(``background.survey_initial_conditions``) for a two-field model, in
NumPy, written from the documented semantics and independent of the
package under test.

From V(x) and G_ab(x), given as sympy expressions, sympy gives ∂_a V,
G_ab and ∂_c G_ab; everything else is NumPy on the point values, in the
dtype asked for:

* the state y = [φ⁰, φ¹, χ⁰, χ¹, H] in cosmic time, with
  φ'^a = χ^a, χ'^a = −Γ^a_bc χ^b χ^c − G^ab ∂_b V − 3H χ^a,
  H' = −½ G_ab χ^a χ^b, and H(0) = √((V + ½ G_ab χ^a χ^b)/3);
* Runge-Kutta-Fehlberg 4(5) (Fehlberg's tableau, the 5th-order solution
  kept), one output row per accepted step, row 0 the initial state; the
  step control starts at dt = 1e-10, takes err = ‖y₅ − y₄‖₂ over all five
  components, accepts where err/max_err ≤ 1.1 (or dt ≤ 1e-250, or dt not
  finite) and after every attempt scales dt by (max_err/err)^(1/7) (one
  over the stages + 1) clamped to [0.1, 5] (5 where err = 0, 0.1 where err
  is not finite);
* the summary of each trajectory: ε_H = ½ G_ab χ^a χ^b / H²; the e-folds
  N(t) = ∫H dt by the trapezoid rule with the cubic-Hermite correction
  Δt²/12·(Ḣᵢ − Ḣᵢ₊₁); inflation starts at the first row with ε_H < 1 (finite,
  H > 0) and ends at the first later row with ε_H ≥ 1; N, H and the fields
  at the end are interpolated linearly in ε_H between that row and the one
  before; ``N_inflation`` is the e-folds from start to end (NaN where it
  does not end), ``N_span`` those of all rows.

An attempt whose err/max_err lies within ``AMBIGUOUS`` (relatively) of
1.1 could be accepted under one rounding and rejected under another, and
the two integrations then take different step sequences; such a
trajectory is flagged, and the comparison leaves it out.
"""

from __future__ import annotations

import numpy as np
import sympy

_A = [[],
      [1 / 4],
      [3 / 32, 9 / 32],
      [1932 / 2197, -7200 / 2197, 7296 / 2197],
      [439 / 216, -8.0, 3680 / 513, -845 / 4104],
      [-8 / 27, 2.0, -3544 / 2565, 1859 / 4104, -11 / 40]]
_B5 = [16 / 135, 0.0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55]
_B4 = [25 / 216, 0.0, 1408 / 2565, 2197 / 4104, -1 / 5, 0.0]
DT_INIT = 1e-10
DT_FLOOR = 1e-250
AMBIGUOUS = 1e-7


class Background:
    """The background equations of a two-field model with named
    parameters, evaluated in NumPy in the dtype of the state."""

    def __init__(self, fields, params, metric, potential):
        self.params = list(params)
        x = list(fields)
        exprs = [sympy.diff(potential, x[a]) for a in range(2)]
        exprs += [metric[a][b] for a, b in ((0, 0), (0, 1), (1, 1))]
        exprs += [sympy.diff(metric[a][b], x[c])
                  for c in range(2) for a, b in ((0, 0), (0, 1), (1, 1))]
        self._parts = sympy.lambdify([*x, *self.params], exprs, modules="numpy", cse=True)
        self._v = sympy.lambdify([*x, *self.params], potential, modules="numpy")

    def _values(self, fn, x0, x1, p):
        dtype = x0.dtype
        out = fn(x0, x1, *[dtype.type(p[str(s)]) for s in self.params])
        return [np.broadcast_to(np.asarray(v, dtype=dtype), x0.shape) for v in
                (out if isinstance(out, list) else [out])]

    def metric(self, x0, x1, p):
        vals = self._values(self._parts, x0, x1, p)
        G = [[vals[2], vals[3]], [vals[3], vals[4]]]
        dG = [[[vals[5 + 3 * c], vals[6 + 3 * c]], [vals[6 + 3 * c], vals[7 + 3 * c]]]
              for c in range(2)]
        return [vals[0], vals[1]], G, dG

    def kinetic(self, x0, x1, c0, c1, p):
        """G_ab χ^a χ^b."""
        _, G, _ = self.metric(x0, x1, p)
        return G[0][0] * c0 * c0 + 2 * G[0][1] * c0 * c1 + G[1][1] * c1 * c1

    def hubble(self, x0, x1, c0, c1, p):
        (V,) = self._values(self._v, x0, x1, p)
        return np.sqrt((V + 0.5 * self.kinetic(x0, x1, c0, c1, p)) / 3)

    def derivative(self, y, p):
        """y' of the (5, B) state."""
        x0, x1, c0, c1, H = y
        dV, G, dG = self.metric(x0, x1, p)
        det = G[0][0] * G[1][1] - G[0][1] * G[1][0]
        Gi = [[G[1][1] / det, -G[0][1] / det], [-G[1][0] / det, G[0][0] / det]]
        chi = (c0, c1)
        acc = []
        for a in range(2):
            eom = Gi[a][0] * dV[0] + Gi[a][1] * dV[1]
            for b in range(2):
                for c in range(2):
                    gamma = sum(0.5 * Gi[a][d] * (dG[b][d][c] + dG[c][d][b] - dG[d][b][c])
                                for d in range(2))
                    eom = eom + gamma * chi[b] * chi[c]
            acc.append(-eom - 3 * H * chi[a])
        kin = G[0][0] * c0 * c0 + 2 * G[0][1] * c0 * c1 + G[1][1] * c1 * c1
        return np.stack([c0, c1, acc[0], acc[1], -0.5 * kin])


def solve(bg: Background, p: dict, steps: int, fields, velocities, max_err: float, dtype):
    """(B, steps, 5) rows, (B, steps) times and the (B,) flags of
    ambiguous trajectories, from (B, 2) initial fields and velocities."""
    fields = np.asarray(fields, dtype=dtype).T
    vel = np.asarray(velocities, dtype=dtype).T
    batch = fields.shape[1]
    H0 = bg.hubble(fields[0], fields[1], vel[0], vel[1], p)
    y = np.concatenate([fields, vel, H0[None]]).astype(dtype)
    t = np.zeros(batch, dtype)
    dt = np.full(batch, DT_INIT, dtype)
    rows = np.empty((steps, 6, batch), dtype)
    rows[0, :5], rows[0, 5] = y, t
    ambiguous = np.zeros(batch, bool)
    one, max_err, tiny = dtype(1.0), dtype(max_err), np.finfo(dtype).tiny
    with np.errstate(all="ignore"):
        for s in range(1, steps):
            todo = np.arange(batch)
            while todo.size:
                ys, h = y[:, todo], dt[todo]
                ks = []
                for n in range(6):
                    yn = ys
                    for m, a in enumerate(_A[n]):
                        yn = yn + (h * dtype(a)) * ks[m]
                    ks.append(bg.derivative(yn, p))
                hi = ys + sum((h * dtype(b)) * k for b, k in zip(_B5, ks) if b)
                lo = ys + sum((h * dtype(b)) * k for b, k in zip(_B4, ks) if b)
                err = np.sqrt(((hi - lo) ** 2).sum(axis=0))
                ratio = err * (one / max_err)
                q = np.clip((one / np.maximum(err, tiny) * max_err) ** dtype(1 / 7),
                            dtype(0.1), dtype(5.0))
                q = np.where(err > 0, q, dtype(5.0))
                q = np.where(np.isfinite(err), q, dtype(0.1))
                accept = (ratio <= dtype(1.1)) | (h <= DT_FLOOR) | ~np.isfinite(h)
                ambiguous[todo] |= np.abs(ratio - 1.1) <= AMBIGUOUS * 1.1
                y[:, todo] = np.where(accept, hi, ys)
                t[todo] = np.where(accept, t[todo] + h, t[todo])
                dt[todo] = h * q
                todo = todo[~accept]
            rows[s, :5], rows[s, 5] = y, t
    rows = rows.transpose(2, 0, 1)
    return rows[..., :5], rows[..., 5], ambiguous


def summary(bg: Background, p: dict, rows, times):
    """The survey's per-trajectory summary: ``N_inflation``, ``ended``,
    ``H_end``, ``x_end`` ((B, 2)) and ``N_span``."""
    x0, x1, c0, c1, hub = (rows[..., k] for k in range(5))
    with np.errstate(all="ignore"):
        hdot = -0.5 * bg.kinetic(x0, x1, c0, c1, p)
        eps = -hdot / (hub * hub)
        dt = np.diff(times, axis=1)
        seg = 0.5 * (hub[:, 1:] + hub[:, :-1]) * dt + (dt * dt / 12.0) * (hdot[:, :-1] - hdot[:, 1:])
    n = np.concatenate([np.zeros_like(times[:, :1]), np.cumsum(seg, axis=1)], axis=1)
    finite = np.isfinite(eps) & (hub > 0)
    below = finite & (eps < 1)
    inflated = below.any(axis=1)
    start = below.argmax(axis=1)
    idx = np.arange(times.shape[1])[None, :]
    crossing = (idx > start[:, None]) & finite & (eps >= 1)
    ended = inflated & crossing.any(axis=1)
    i = np.maximum(crossing.argmax(axis=1), 1)
    b = np.arange(len(i))

    def interp(arr, frac):
        return arr[b, i - 1] + frac * (arr[b, i] - arr[b, i - 1])

    e0, e1 = eps[b, i - 1], eps[b, i]
    with np.errstate(all="ignore"):
        frac = np.where(e1 != e0, (1 - e0) / (e1 - e0), 0.0)
    nan = np.full(len(i), np.nan)
    return {"N_inflation": np.where(ended, interp(n, frac) - n[b, start], nan),
            "ended": ended,
            "H_end": np.where(ended, interp(hub, frac), nan),
            "x_end": np.where(ended[:, None], np.stack([interp(x0, frac), interp(x1, frac)], 1),
                              np.nan),
            "N_span": n[:, -1]}
