"""The PyTorch port's package boundary: it imports neither jax nor the JAX
package, and exports the surface of ``inflatox_tpu`` that it ports."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPORTS = {
    "InflationModelBuilder",
    "InflationModel",
    "Compiler",
    "CompiledModel",
    "CompilationArtifact",
    "models",
    "background",
    "consistency_conditions",
    "geometry",
    "inference",
    "observables",
    "parallel",
    "perturbations",
    "log_info",
    "log_warn",
    "__version__",
}

MODULES = [
    "inflatox_torch",
    "inflatox_torch.background",
    "inflatox_torch.compiler",
    "inflatox_torch.consistency_conditions",
    "inflatox_torch.geometry",
    "inflatox_torch.inference",
    "inflatox_torch.lowering.cuda_codegen",
    "inflatox_torch.lowering.torch_lowering",
    "inflatox_torch.models",
    "inflatox_torch.native",
    "inflatox_torch.native.backend",
    "inflatox_torch.native.codegen",
    "inflatox_torch.observables",
    "inflatox_torch.ops.build",
    "inflatox_torch.ops.cuda_kernels",
    "inflatox_torch.ops.cuda_solver",
    "inflatox_torch.parallel",
    "inflatox_torch.parallel.distributed",
    "inflatox_torch.parallel.mesh",
    "inflatox_torch.parallel.solve",
    "inflatox_torch.parallel.sweep",
    "inflatox_torch.perturbations",
    "inflatox_torch.symbolic",
    "inflatox_torch.utils.devices",
    "inflatox_torch.utils.profiling",
]


@pytest.fixture(scope="module")
def imported_modules() -> dict:
    """Import MODULES one by one, in order, in one fresh process; after each
    import, record whether jax or inflatox_tpu has been imported."""
    code = (
        "import importlib, json, sys\n"
        "seen = {}\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    seen[name] = {'jax': 'jax' in sys.modules,"
        " 'inflatox_tpu': 'inflatox_tpu' in sys.modules,"
        " 'recursionlimit': sys.getrecursionlimit()}\n"
        "print(json.dumps(seen))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax(imported_modules, module):
    seen = imported_modules[module]
    assert not seen["jax"], f"importing {module} imported jax"
    assert not seen["inflatox_tpu"], f"importing {module} imported inflatox_tpu"
    assert seen["recursionlimit"] >= 100_000


def test_examples_import_no_jax():
    """Loading each of the port's example scripts (``examples/torch_*.py``,
    their ``main`` not run) in one fresh process imports neither jax nor
    inflatox_tpu."""
    code = (
        "import glob, importlib.util, json, os, sys\n"
        "seen = {}\n"
        "for path in sorted(glob.glob(os.path.join('examples', 'torch_*.py'))):\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    seen[path] = ['jax' in sys.modules, 'inflatox_tpu' in sys.modules]\n"
        "print(json.dumps(seen))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300, check=True,
    )
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(seen) == 8
    assert not any(a or b for a, b in seen.values()), seen


def test_exported_names():
    import inflatox_torch

    assert set(inflatox_torch.__all__) == EXPORTS
    for name in EXPORTS:
        assert hasattr(inflatox_torch, name), name
    assert inflatox_torch.CompilationArtifact is inflatox_torch.CompiledModel


def test_parallel_exports_the_jax_packages_names():
    import inflatox_torch.parallel as tpar
    import inflatox_tpu.parallel as jpar

    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert hasattr(tpar, name), name
    assert set(tpar.distributed.__all__) == set(jpar.distributed.__all__)


def test_schema_version_is_shared():
    import inflatox_torch.version as tv
    import inflatox_tpu.version as jv

    assert tv.__schema_version__ == jv.__schema_version__
    assert tv.__abi_version__ == jv.__abi_version__ == tv.__schema_version__


def test_sources_import_no_jax():
    """No source of the port, nor chip_smoke.py nor the port's examples, has
    an import of jax or of the JAX package (names in comments and
    docstrings are fine)."""
    import re
    from pathlib import Path

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|inflatox_tpu)\b", re.MULTILINE)
    sources = (sorted(Path(REPO, "inflatox_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
               + sorted(Path(REPO, "examples").glob("torch_*.py")))
    assert len(sources) > 10
    offending = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offending
