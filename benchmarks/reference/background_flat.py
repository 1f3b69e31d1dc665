"""The plain reference's background solve (``background.solve``: the same
equations, tableau, step control and ambiguity flags, in the dtype asked
for), with every trajectory's attempts in one flat loop, as kernel B6 runs
them: each pass makes one attempt of every trajectory that has rows left,
and an accepted attempt stores that trajectory's next row.

Each trajectory's attempts are its own, so the rows are those of
``background.solve``; only the passes differ.  ``background.solve`` makes
the whole batch wait at every row for the trajectory that needs the most
attempts there, so it makes the sum over rows of those most attempts; this
loop makes the most attempts of one trajectory over all its rows.  Where
trajectories reject at different rows, as in angular inflation near the
edge of its disc (a state that is no longer finite takes about 240
rejected attempts to bring its step to the floor), that is the difference
between hours and seconds.
"""

from __future__ import annotations

import numpy as np
from background import _A, _B4, _B5, AMBIGUOUS, DT_FLOOR, DT_INIT


def solve(bg, p: dict, steps: int, fields, velocities, max_err: float, dtype):
    """(B, steps, 5) rows, (B, steps) times and the (B,) flags of
    ambiguous trajectories, from (B, 2) initial fields and velocities, as
    ``background.solve`` returns them."""
    fields = np.asarray(fields, dtype=dtype).T
    vel = np.asarray(velocities, dtype=dtype).T
    batch = fields.shape[1]
    H0 = bg.hubble(fields[0], fields[1], vel[0], vel[1], p)
    y = np.concatenate([fields, vel, H0[None]]).astype(dtype)
    t = np.zeros(batch, dtype)
    dt = np.full(batch, DT_INIT, dtype)
    rows = np.empty((steps, 6, batch), dtype)
    rows[0, :5], rows[0, 5] = y, t
    row = np.ones(batch, np.int64)  # each trajectory's next row
    ambiguous = np.zeros(batch, bool)
    one, max_err, tiny = dtype(1.0), dtype(max_err), np.finfo(dtype).tiny
    todo = np.arange(batch) if steps > 1 else np.arange(0)
    with np.errstate(all="ignore"):
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
            done = todo[accept]
            rows[row[done], :5, done] = y[:, done].T
            rows[row[done], 5, done] = t[done]
            row[done] += 1
            todo = todo[row[todo] < steps]
    rows = rows.transpose(2, 0, 1)
    return rows[..., :5], rows[..., 5], ambiguous
