"""The port's example scripts (``examples/torch_*.py``) run on the CPU, at
reduced sizes, with ``--device cpu``: each runs to its end and its own
checks hold."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_posterior_example_runs_on_the_cpu():
    """examples/torch_posterior.py at 4 chains × 400 draws after 200 warmup
    (the script's defaults are 3000 and 1000): its posterior variances
    within 20 % of the Fisher forecast, as at full size."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_posterior.py"),
         "--device", "cpu", "--num-samples", "400", "--num-warmup", "200"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MCMC posterior matches the autodiff Fisher forecast" in out.stdout
