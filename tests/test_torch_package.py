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
    "parallel",
    "log_info",
    "log_warn",
}

MODULES = [
    "inflatox_torch",
    "inflatox_torch.background",
    "inflatox_torch.compiler",
    "inflatox_torch.consistency_conditions",
    "inflatox_torch.lowering.cuda_codegen",
    "inflatox_torch.lowering.torch_lowering",
    "inflatox_torch.models",
    "inflatox_torch.ops.build",
    "inflatox_torch.ops.cuda_kernels",
    "inflatox_torch.ops.cuda_solver",
    "inflatox_torch.parallel",
    "inflatox_torch.parallel.sweep",
    "inflatox_torch.symbolic",
    "inflatox_torch.utils.devices",
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


def test_exported_names():
    import inflatox_torch

    assert set(inflatox_torch.__all__) == EXPORTS
    for name in EXPORTS:
        assert hasattr(inflatox_torch, name), name
    assert inflatox_torch.CompilationArtifact is inflatox_torch.CompiledModel


def test_schema_version_is_shared():
    import inflatox_torch.version as tv
    import inflatox_tpu.version as jv

    assert tv.__schema_version__ == jv.__schema_version__


def test_sources_import_no_jax():
    """No source of the port, nor chip_smoke.py, has an import of jax or of
    the JAX package (names in comments and docstrings are fine)."""
    import re
    from pathlib import Path

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|inflatox_tpu)\b", re.MULTILINE)
    sources = sorted(Path(REPO, "inflatox_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    assert len(sources) > 10
    offending = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offending
