"""Generated kernel headers of another checkout of inflatox_torch.

    from tree_headers import tree_headers
    tree_headers("/path/to/checkout", ("solver", "egno"))  # {"solver": ..., "egno": ...}

The probes compare this checkout's kernels with another tree's (the parent
commit unpacked with ``git archive`` under ``build/``, say).  A tree's
``csrc/`` goes with the headers its own code generator emits, so each tree's
headers come from a subprocess that imports that tree's package first: the
hyperinflation model (``models.hyperinflation()``, compiled as
``chip_smoke.py`` compiles it), EGNO and D5 from the tree's own
``tests/fixtures`` bundles, S1-S3 built from their potentials as
``chip_smoke.py`` builds them.
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
if "angular" in names:
    model, args = inflatox_torch.models.angular()
    out["angular"] = inflatox_torch.Compiler(model, silent=True).compile().cuda_source("f64")
if "d5" in names:
    d5 = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "d5_bundle.json"))
    out["d5"] = d5.cuda_source("f64")
if "egno" in names:
    egno = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "egno_bundle.json"))
    out["egno"] = egno.cuda_source("dd")
if {"s1", "s2", "s3"} & set(names):
    import sympy

    x, y, a = sympy.symbols("x y a")
    half, th, fh = sympy.Rational(1, 2), sympy.Rational(3, 2), sympy.Rational(5, 2)
    potentials = {
        "s1": (a * sympy.hyper((half,), (th,), -(x**2))
               + sympy.hyper((half, th), (fh,), y**2 / 4) / 10
               + sympy.erf(x) * sympy.gamma(y + 2) / 50 + 2),
        "s2": a * sympy.besselj(0, x) ** 2 + sympy.besselk(1, x + 2) * y**2 + 2,
        "s3": (a * sympy.besselj(sympy.Rational(3, 10), x) ** 2
               + sympy.besselk(sympy.Rational(5, 2), x + 2) * y**2 + 2),
    }
    for name in {"s1", "s2", "s3"} & set(names):
        model = inflatox_torch.InflationModelBuilder.new(
            [x, y], [[1, 0], [0, 1]], potentials[name], name.upper(), silent=True,
            simplify=False, assertions=False).build()
        out[name] = inflatox_torch.Compiler(model, silent=True).compile().cuda_source("f64")
json.dump({k: out[k] for k in names}, sys.stdout)
"""


NAMES = ("solver", "f64", "f32", "angular", "d5", "egno", "s1", "s2", "s3")


def tree_headers(root: str, names=NAMES) -> dict:
    """The headers ``names`` of the checkout at ``root``, generated by its
    own package: ``solver`` (hyperinflation), ``f64`` and ``f32``
    (hyperinflation), ``angular`` and ``d5`` (f64), ``egno`` (double-double) and ``s1``,
    ``s2``, ``s3`` (``chip_smoke.py``'s special-function models, f64)."""
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, root, ",".join(names)], cwd=root,
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"header generation in {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout)
