"""Traffic kind ``sweep``: one ``inflatox_torch.parallel.parameter_sweep``
a call over a batch of parameter sets, each set's maps reduced on the
device to its least finite value of the first map and that map on a
sub-lattice, so that only the reductions reach the host.

Parameters (the workload's ``traffic``): ``analysis`` (the analysis kind),
``shape`` (N0, N1), ``sets`` (parameter sets a call), ``chunk_size`` (sets
a launch; null: all in one), ``stride`` (the sub-lattice's step),
``vary`` and ``range`` (the parameter drawn for each set, uniformly: one
that moves the maps, so that every set's answer differs from the others'),
``min_call_ms``, ``trace_calls``, ``check_calls`` and ``check_among`` (as
for ``maps``) and ``check_min_sets`` (sets of each checked call whose
least value the reference recomputes over the whole grid; every set's
sub-lattice is checked).  Each call scans the configuration's ``window``
shifted by a fraction of a grid step drawn from the seed.
"""

import numpy as np
import torch
from anguelova import TwoFieldModel, analysis, axis
from harness import scaled_gaps

#: where the calls reach the program's batched grid scan, and the faults a
#: cell of this kind can have (``benchmarks/faults.py``)
SCANS = ("inflatox_torch.parallel.sweep", ("scan_batch_cuda", "scan_batch_torch"), 0)
FAULTS = ("altered", "half_left_out", "swapped_sets", "unchanged_state")


def reducer(stride: int):
    """(n_out, N0, N1) maps → [least finite value of map 0, map 0 on the
    sub-lattice of step ``stride``], in torch operations."""
    def reduce(maps):
        m = maps[0]
        least = torch.where(torch.isfinite(m), m, float("inf")).amin()
        return torch.cat([least.reshape(1), m[::stride, ::stride].reshape(-1)])

    return reduce


class Traffic:
    def __init__(self, ctx):
        from inflatox_torch.parallel import parameter_sweep

        self.ctx = ctx
        t = ctx.traffic
        self.sweep = parameter_sweep
        self.shape = tuple(int(n) for n in t["shape"])
        self.sets = int(t["sets"])
        self.chunk = t["chunk_size"]
        self.stride = int(t["stride"])
        self.reduce = reducer(self.stride)
        self.n_inputs = ctx.n_inputs()
        lo, hi = t["range"]
        self.values = ctx.rng.uniform(lo, hi, (self.n_inputs, self.sets))
        self.windows = ctx.windows(self.n_inputs, self.shape)
        self.picks = ctx.picks(int(t["check_calls"]), int(t["check_among"]))
        self.min_sets = int(t["check_min_sets"])
        self.kept = {}
        self.launch = {"kind": t["analysis"], "shape": self.shape,
                       "sets": int(self.chunk or self.sets),
                       "n_out": 6 if t["analysis"] == "complete_analysis" else 1,
                       "itemsize": 4 if ctx.precision == "f32" else 8}
        # the warm call, at the cell's shapes
        self._sweep(np.linspace(lo, hi, self.sets), ctx.config["window"])

    def _sweep(self, values, window):
        base = self.ctx.args(self.ctx.config["parameters"])
        batch = np.repeat(base[None], len(values), axis=0)
        slot = self.ctx.art.symbol_dictionary[self.ctx.traffic["vary"]]
        batch[:, int(slot[5:-1])] = values
        return self.sweep(self.ctx.al, batch, tuple(window), self.shape,
                          chunk_size=self.chunk, progress=False, reduce_fn=self.reduce,
                          kind=self.ctx.traffic["analysis"], precision=self.ctx.precision)

    def call(self, i):
        out = self._sweep(self.values[i], self.windows[i])
        if i in self.picks:
            self.kept[i] = out
        return {"points": self.sets * self.shape[0] * self.shape[1]}

    def check(self):
        """The widest scaled gap |p − r| / max(|r|, 1) over every set's
        sub-lattice and the sampled sets' least values of the kept calls,
        and the places finite on one side only."""
        if not self.kept:  # no drawn call finished: nothing was checked
            return {"max_gap": float("nan"), "mask_mismatch": float("nan")}
        ref = self.ctx.reference
        model = TwoFieldModel(*ref.model())
        kind = self.ctx.traffic["analysis"]
        vary = self.ctx.traffic["vary"]
        n0, n1 = self.shape
        s = self.stride
        gap, mismatch = 0.0, 0

        def params(values):
            return {**self.ctx.config["parameters"], vary: values}

        for i, out in sorted(self.kept.items()):
            x0a, x0b, x1a, x1b = self.windows[i]
            sub0 = axis(x0a, x0b, n0, np.arange(0, n0, s), ref.DTYPE)[None, :, None]
            sub1 = axis(x1a, x1b, n1, np.arange(0, n1, s), ref.DTYPE)[None, None, :]
            full1 = axis(x1a, x1b, n1, np.arange(n1), ref.DTYPE)[None, :]
            vals = self.values[i].astype(ref.DTYPE)
            want = analysis(model, kind, sub0, sub1, params(vals[:, None, None]))[0]
            g, m = scaled_gaps(out[:, 1:], want.reshape(self.sets, -1))
            gap, mismatch = max(gap, g), mismatch + m
            for k in self.ctx.rng.choice(self.sets, self.min_sets, replace=False):
                least = np.inf
                for r0 in range(0, n0, 256):
                    x0 = axis(x0a, x0b, n0, np.arange(r0, min(n0, r0 + 256)), ref.DTYPE)
                    m0 = analysis(model, kind, x0[:, None], full1, params(vals[k]))[0]
                    finite = m0[np.isfinite(m0)]
                    least = min(least, finite.min()) if finite.size else least
                g, m = scaled_gaps(out[k, :1], np.array([least]))
                gap, mismatch = max(gap, g), mismatch + m
        return {"max_gap": gap, "mask_mismatch": mismatch}
