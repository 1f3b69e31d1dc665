"""Traffic kind ``survey``: one ``inflatox_torch.background.
survey_initial_conditions`` a call over a batch of initial fields, each
trajectory integrated by kernel B6 and reduced on the device to its
summary (e-folds of inflation, whether and where it ends, the e-folds of
the whole span), only the summaries reaching the host.

Parameters (the workload's ``traffic``): ``batch`` (initial conditions a
call), ``box`` (the ranges of the two fields; the velocities are zero),
``pool`` (batches drawn uniformly in the box before the window; call i
takes batch i mod ``pool``, shifted on each axis by an offset drawn for
the call and wrapped into the box, so that every call's fields are
uniform in the box and differ from every other call's), ``steps`` (output
rows), ``max_err``, ``solver``,
``chunk``, ``min_call_ms``, ``trace_calls``, ``check_calls`` and
``check_among`` (as for ``maps``).  The reference (``reference/background.py``)
integrates every trajectory of the checked calls again with the same
documented method and step control.  Where the cell runs at a precision
below the configuration's (the control), the program has no such path:
the reference at that precision takes the program's place.
"""

import numpy as np
from harness import log, scaled_gaps
from background import Background, solve, summary

#: where the calls reach the program's survey reduction, and the faults a
#: cell of this kind can have (``benchmarks/faults.py``)
SCANS = ("inflatox_torch.background", ("_survey_reduce",), 0)
FAULTS = ("altered", "half_left_out", "unchanged_state")

#: the summaries compared: not ``N_span``, the e-folds of every row, which
#: takes in the collapse after inflation (H < 0), where trajectories part
#: exponentially and rounding alone moves it by 1e-4
KEYS = ("N_inflation", "H_end", "x_end")
DTYPES = {"f64": np.float64, "f32": np.float32}


class Traffic:
    def __init__(self, ctx):
        from inflatox_torch.background import survey_initial_conditions

        self.ctx = ctx
        t = ctx.traffic
        self.survey = survey_initial_conditions
        self.batch = int(t["batch"])
        self.n_inputs = ctx.n_inputs()
        box = np.asarray(t["box"], dtype=np.float64)
        self.lo, self.width = box[:, 0], box[:, 1] - box[:, 0]
        self.pool = ctx.rng.uniform(box[:, 0], box[:, 1], (int(t["pool"]), self.batch, 2))
        self.offsets = ctx.rng.uniform(0.0, self.width, (self.n_inputs, 2))
        self.picks = ctx.picks(int(t["check_calls"]), int(t["check_among"]))
        self.params = ctx.config["parameters"]
        self.args = ctx.args(self.params)
        self.kept = {}
        self.launch = {}
        self.program = ctx.precision == ctx.config["precision"]
        if self.program:  # the warm call, at the cell's shapes
            self._survey(ctx.rng.uniform(box[:, 0], box[:, 1], (self.batch, 2)))

    def _survey(self, fields):
        t = self.ctx.traffic
        return self.survey(self.ctx.art, self.args, int(t["steps"]), fields,
                           np.zeros(2), max_err=float(t["max_err"]), solver=t["solver"],
                           chunk=int(t["chunk"]), device=self.ctx.device)

    def fields(self, i):
        """The (batch, 2) initial fields of call i."""
        shifted = self.pool[i % len(self.pool)] - self.lo + self.offsets[i]
        return self.lo + np.mod(shifted, self.width)

    def _reference(self, i, dtype):
        ref = self.ctx.reference
        bg = Background(*ref.model())
        t = self.ctx.traffic
        rows, times, ambiguous = solve(bg, self.params, int(t["steps"]), self.fields(i),
                                       np.zeros((self.batch, 2)), float(t["max_err"]), dtype)
        return summary(bg, self.params, rows, times), ambiguous

    def call(self, i):
        if self.program:
            out = self._survey(self.fields(i))
        elif i in self.picks:  # the control: the reference at the lower precision
            out, _ = self._reference(i, DTYPES[self.ctx.precision])
        else:
            out = None
        if i in self.picks:
            self.kept[i] = out
        return {"trajectories": self.batch}

    def check(self):
        """The widest scaled gap |p − r| / max(|r|, 1) over the compared
        summaries (``KEYS``) of every trajectory of the kept calls, those
        that the reference flags ambiguous left out, and the places finite
        on one side only (with the trajectories whose ``ended`` differs)."""
        if not self.kept:  # no drawn call finished: nothing was checked
            return {"max_gap": float("nan"), "mask_mismatch": float("nan")}
        gap, mismatch, left_out = 0.0, 0, 0
        for i, got in sorted(self.kept.items()):
            want, ambiguous = self._reference(i, np.float64)
            keep = ~ambiguous
            left_out += int(ambiguous.sum())
            for k in KEYS:
                g, m = scaled_gaps(np.asarray(got[k])[keep], want[k][keep])
                gap, mismatch = max(gap, g), mismatch + m
            mismatch += int((np.asarray(got["ended"])[keep] != want["ended"][keep]).sum())
        log(f"survey check: {left_out} trajectories flagged ambiguous, left out")
        return {"max_gap": gap, "mask_mismatch": mismatch}
