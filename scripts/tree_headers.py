"""Generated kernel headers of another checkout of inflatox_torch.

    from tree_headers import tree_headers
    tree_headers("/path/to/checkout", ("solver", "egno"))  # {"solver": ..., "egno": ...}

The probes compare this checkout's kernels with another tree's (the parent
commit unpacked with ``git archive`` under ``build/``, say).  A tree's
``csrc/`` goes with the headers its own code generator emits, so each tree's
headers come from a subprocess that imports that tree's package first: the
hyperinflation model (``models.hyperinflation()``, compiled as
``chip_smoke.py`` compiles it), EGNO and D5 from the tree's own
``tests/fixtures`` bundles.
"""

import json
import os
import subprocess
import sys

_SCRIPT = r"""
import json, os, sys
root, names = sys.argv[1], sys.argv[2].split(",")
sys.path.insert(0, root)
import inflatox_torch
fixtures = os.path.join(root, "tests", "fixtures")
out = {}
if {"solver", "f64", "f32"} & set(names):
    model, args = inflatox_torch.models.hyperinflation()
    hyp = inflatox_torch.Compiler(model, silent=True).compile()
    out.update(solver=hyp.cuda_solver_source(), f64=hyp.cuda_source("f64"),
               f32=hyp.cuda_source("f32"))
if "d5" in names:
    d5 = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "d5_bundle.json"))
    out["d5"] = d5.cuda_source("f64")
if "egno" in names:
    egno = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "egno_bundle.json"))
    out["egno"] = egno.cuda_source("dd")
json.dump({k: out[k] for k in names}, sys.stdout)
"""


NAMES = ("solver", "f64", "f32", "d5", "egno")


def tree_headers(root: str, names=NAMES) -> dict:
    """The headers ``names`` of the checkout at ``root``, generated by its
    own package: ``solver`` (hyperinflation), ``f64`` and ``f32``
    (hyperinflation), ``d5`` (f64) and ``egno`` (double-double)."""
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, root, ",".join(names)], cwd=root,
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"header generation in {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout)
