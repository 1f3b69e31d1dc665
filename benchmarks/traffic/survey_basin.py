"""Traffic kind ``survey_basin``: the calls of the kind ``survey``
(``traffic/survey.py``, reused unchanged: one ``inflatox_torch.background.
survey_initial_conditions`` a call over a batch of initial fields drawn in
a box, at rest), checked only where the reference pins the answer down.

At the edge of a basin of attraction a trajectory's outcome depends on its
start more finely than rounding does: two integrations that differ in the
last bit of one operation part, and their e-folds then differ by anything
up to the whole.  In angular inflation at the edge of its rapid-turn
attractor, starts 0.009 apart give 0.14 and 145 e-folds, and about a third
of the starts of the box [0.64, 0.705]² move by more than the limit when
they are nudged by 1e-12.  No program that rounds otherwise than the
reference can match those, so the check integrates each checked trajectory
again from its start nudged by ``NUDGE`` relatively, each field up or down
(``PROBES``), and leaves out every trajectory whose own reference moves
under a nudge by more than ``CONDITION`` of the limit on ``max_gap`` in a
compared summary, or changes whether inflation ended: such a trajectory is
ill-conditioned.  The nudge is larger than rounding, so that it moves the
reference at least as far as the program's rounding does: a nudge of 1e-12
moved some trajectories 37,000 times less than B6's rounding did.  Ambiguous trajectories are left out as ``survey`` leaves
them out; both counts are logged.

The reference is ``background.py``'s equations, method and step control,
run with every trajectory's attempts in one flat loop
(``reference/background_flat.py``: ``background.solve`` makes the batch
wait at every row for its slowest trajectory, and this model's
trajectories that leave the disc's representable interior take about 240
attempts at one row).  It integrates the trajectories of a sub-lattice of
each checked call, every ``check_stride``-th one from the first, spread over
the batch and its chunks; those of all checked calls and their nudged starts
run in one flat loop.  Several calls, each sampled more thinly, hold the
same work as one call sampled densely, and a fault that touches a few
trajectories of each call is seen unless all of them are ill-conditioned.

Parameters (the workload's ``traffic``): those of ``survey``, and
``check_stride``.
"""

import numpy as np
from background import Background, summary
from background_flat import solve
from harness import load_module, log, scaled_gaps

_survey = load_module("traffic", "survey.py")
SCANS, FAULTS, KEYS, DTYPES = _survey.SCANS, _survey.FAULTS, _survey.KEYS, _survey.DTYPES

#: relative nudge of a start, and the signs it is applied with to the two
#: fields: one reference integration each
NUDGE = 1e-9
PROBES = ((1, 1), (-1, -1), (1, -1), (-1, 1))
#: the share of the ``max_gap`` limit that a nudge may move a trajectory's
#: own reference by before it is ill-conditioned: a nudge of the start is
#: one perturbation, where the program's rounding differs from the
#: reference's in every operation along the way (on the card, B6's summaries
#: moved up to 633 times as far from the reference as a nudge of 1e-9 did,
#: and of 6,144 starts none that this bound keeps moved by more than 1.32e-6)
CONDITION = 0.01


def _gaps(a, b):
    """Per trajectory, the widest |a − b| / max(|b|, 1) over a summary's
    columns where both are finite; inf where one side only is finite."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    gap = np.where(np.isfinite(a) & np.isfinite(b), gap, 0.0)
    gap = np.where(np.isfinite(a) != np.isfinite(b), np.inf, gap)
    return gap.reshape(len(gap), -1).max(axis=1)


class Traffic(_survey.Traffic):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.sample = np.arange(0, self.batch, int(ctx.traffic["check_stride"]))

    def _solve(self, fields, dtype):
        ref = self.ctx.reference
        bg = Background(*ref.model())
        t = self.ctx.traffic
        rows, times, ambiguous = solve(bg, self.params, int(t["steps"]), fields,
                                       np.zeros_like(fields), float(t["max_err"]), dtype)
        return summary(bg, self.params, rows, times), ambiguous

    def _reference(self, i, dtype):
        """The summaries of call i's sampled trajectories at ``dtype`` (the
        control's place of the program) and their ambiguous flags."""
        return self._solve(self.fields(i)[self.sample], dtype)

    def _conditioned(self, fields):
        """The f64 summaries of the trajectories from ``fields`` ((n, 2)
        starts at rest), their ambiguous flags and their ill-conditioned
        flags, from one flat integration of the starts and of each nudge of
        them."""
        n = len(fields)
        starts = [fields] + [fields * (1.0 + NUDGE * np.array(s)) for s in PROBES]
        out, ambiguous = self._solve(np.concatenate(starts), np.float64)
        parts = [{k: v[j * n:(j + 1) * n] for k, v in out.items()}
                 for j in range(len(starts))]
        want, bound = parts[0], CONDITION * float(self.ctx.workload["limits"]["max_gap"])
        ill = np.zeros(n, bool)
        for probe in parts[1:]:
            ill |= probe["ended"] != want["ended"]
            for k in KEYS:
                ill |= _gaps(probe[k], want[k]) > bound
        return want, ambiguous[:n], ill

    def check(self):
        """As ``survey``'s check over the sampled trajectories of the kept
        calls (one flat integration for all of them), those that the
        reference flags ambiguous or ill-conditioned left out."""
        if not self.kept:  # no drawn call finished: nothing was checked
            return {"max_gap": float("nan"), "mask_mismatch": float("nan")}
        calls = sorted(self.kept)
        got = {}
        for i in calls:
            out = self.kept[i]
            if len(out["ended"]) == self.batch:  # the program's whole batch
                out = {k: np.asarray(v)[self.sample] for k, v in out.items()}
            for k in (*KEYS, "ended"):
                got.setdefault(k, []).append(np.asarray(out[k]))
        got = {k: np.concatenate(v) for k, v in got.items()}
        want, ambiguous, ill = self._conditioned(
            np.concatenate([self.fields(i)[self.sample] for i in calls]))
        keep = ~(ambiguous | ill)
        gap, mismatch = 0.0, int((got["ended"][keep] != want["ended"][keep]).sum())
        for k in KEYS:
            g, m = scaled_gaps(got[k][keep], want[k][keep])
            gap, mismatch = max(gap, g), mismatch + m
        log(f"survey check: {len(calls)} calls, {int(keep.sum())} trajectories compared, "
            f"{int(ambiguous.sum())} flagged ambiguous and {int((ill & ~ambiguous).sum())} "
            f"ill-conditioned, left out")
        return {"max_gap": gap, "mask_mismatch": mismatch}
