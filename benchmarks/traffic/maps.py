"""Traffic kind ``maps``: one grid analysis a call through
``GeneralisedAL.<entry>`` (``complete_analysis`` and kin), the maps
returned as numpy arrays, as the package's README calls it.

Parameters (the workload's ``traffic``): ``entry`` and ``analysis`` (the
method and its analysis kind), ``shape`` (N0, N1), ``vary`` (the parameter
drawn anew for each call) and ``range`` (its uniform range), ``output``,
``min_call_ms`` (the fastest call the inputs must last for),
``trace_calls`` (calls under the profiler in a traced run), ``check_calls``
(calls whose maps the reference checks, drawn from the seed among the
first ``check_among``).  Each call scans the configuration's ``window``
shifted by a fraction of a grid step drawn from the seed, so that every
call's answer differs from every other's.
"""

import numpy as np
from anguelova import TwoFieldModel, analysis, axis
from harness import scaled_gaps

#: where the calls reach the program's grid scan, and the faults a cell of
#: this kind can have (``benchmarks/faults.py``)
SCANS = ("inflatox_torch.consistency_conditions", ("scan_cuda", "scan_torch"), 1)
FAULTS = ("altered", "half_left_out", "unchanged_state")


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.shape = tuple(int(n) for n in t["shape"])
        self.n_inputs = ctx.n_inputs()
        lo, hi = t["range"]
        self.values = ctx.rng.uniform(lo, hi, self.n_inputs)
        self.windows = ctx.windows(self.n_inputs, self.shape)
        self.picks = ctx.picks(int(t["check_calls"]), int(t["check_among"]))
        self.kept = {}
        self.method = getattr(ctx.al, t["entry"])
        n_out = 6 if t["analysis"] == "complete_analysis" else 1
        self.launch = {"kind": t["analysis"], "shape": self.shape, "sets": 1, "n_out": n_out,
                       "itemsize": 4 if ctx.precision == "f32" else 8}
        self._scan(0.5 * (lo + hi), ctx.config["window"])  # the warm call, at the cell's shapes

    def _params(self, value):
        return {**self.ctx.config["parameters"], self.ctx.traffic["vary"]: float(value)}

    def _scan(self, value, window):
        return self.method(self.ctx.args(self._params(value)), *window, *self.shape,
                           progress=False, output=self.ctx.traffic["output"],
                           precision=self.ctx.precision)

    def call(self, i):
        out = self._scan(self.values[i], self.windows[i])
        if i in self.picks:
            self.kept[i] = out
        return {"points": self.shape[0] * self.shape[1]}

    def check(self):
        """The widest scaled gap |p − r| / max(|r|, 1) over every map of
        the kept calls, and the places finite on one side only."""
        if not self.kept:  # no drawn call finished: nothing was checked
            return {"max_gap": float("nan"), "mask_mismatch": float("nan")}
        ref = self.ctx.reference
        model = TwoFieldModel(*ref.model())
        n0, n1 = self.shape
        gap, mismatch = 0.0, 0
        block = 256
        for i, maps in sorted(self.kept.items()):
            maps = maps if isinstance(maps, tuple) else (maps,)
            x0a, x0b, x1a, x1b = self.windows[i]
            x1 = axis(x1a, x1b, n1, np.arange(n1), ref.DTYPE)[None, :]
            for r0 in range(0, n0, block):
                rows = np.arange(r0, min(n0, r0 + block))
                x0 = axis(x0a, x0b, n0, rows, ref.DTYPE)[:, None]
                want = analysis(model, self.ctx.traffic["analysis"], x0, x1,
                                self._params(self.values[i]))
                for got, w in zip(maps, want):
                    g, m = scaled_gaps(got[rows], w)
                    gap, mismatch = max(gap, g), mismatch + m
        return {"max_gap": gap, "mask_mismatch": mismatch}

