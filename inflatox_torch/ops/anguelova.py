"""Point math for the (generalised) Anguelova-Lazaroiu consistency condition.

The plain-f64 ops of ``inflatox_tpu/ops/anguelova.py:45-113`` (the ones its
``engine="xla"`` path and the native C oracle use), over torch tensors.  All
functions are elementwise over broadcastable float64 tensors.  The CUDA
kernel's tail (``csrc/anguelova.cuh``) computes the same formulas in the
same operation order.

Numerical-parity notes (deliberately replicated from the reference):

* ``complete_analysis_op`` computes ε_V **without** the ½ factor
  (anguelova.rs:119), while ``epsilon_v_only_op`` **includes** it
  (anguelova.rs:138-140).
* ``complete_analysis_op``'s consistency uses |lhs − rhs| in the numerator
  (anguelova.rs:115) whereas the standalone conditions use ||lhs| − |rhs||
  (anguelova.rs:153,162).
* The ratio metric is clamped to ≤ 1; NaN propagates through the clamp.
* η_∥ = ω·tan_delta − 3, with ``tan_delta`` used directly
  (tan(atan(x)) ≡ x; the C oracle's form is not used).

The JAX package's ``_df`` scale-invariant forms are not ported: the port
matches ``engine="xla"`` and the C oracle, also at v00 ≡ 0 (ROADMAP C4).
``flag_quantum_diff_op`` implements the *documented* intent of the
reference (|∂_a V| ≤ accuracy for every raw gradient component), as the JAX
package does.
"""

from __future__ import annotations

import torch

__all__ = [
    "complete_analysis_op",
    "consistency_only_op",
    "consistency_rapidturn_only_op",
    "epsilon_v_only_op",
    "flag_quantum_diff_op",
]


def _ratio_metric(num, lhs, rhs):
    """|num| / (|lhs| + |rhs|), clamped to the mathematical bound ≤ 1.
    NaNs propagate unchanged."""
    return torch.clamp(torch.abs(num) / (torch.abs(lhs) + torch.abs(rhs)), max=1.0)


def complete_analysis_op(v, v00, v10, v11, grad_sq):
    """All six AL-analysis quantities from one set of model evaluations.

    Mirrors ops::complete_analysis (anguelova.rs:103-135).  Inputs are the
    potential V, projected Hesse components V_vv, V_vw, V_ww and |∇V|².
    Returns (consistency, ε_V, ε_H, η_∥, δ, ω)."""
    lhs = v11 / v
    rhs = 3.0 + 3.0 * (v00 / v10) ** 2 + (v00 / v) * (v10 / v00) ** 2
    consistency = _ratio_metric(lhs - rhs, lhs, rhs)

    epsilon_v = grad_sq / v**2  # no ½ here — anguelova.rs:119

    vtt = (v00 * v10**2 + v11 * v00**2 - 2.0 * v00 * v10**2) / (v00**2 + v10**2)
    vt2 = epsilon_v / (1.0 + (v00 / v10) ** 2)
    epsilon_h = 3.0 * (epsilon_v - vt2) / (epsilon_v + torch.abs(vtt) / v - vt2)
    tan_delta = torch.abs(v10 / v00)
    delta = torch.atan(tan_delta)
    omega = torch.sqrt((vtt / v) * (3.0 - epsilon_h))
    eta_parallel = omega * tan_delta - 3.0
    return consistency, epsilon_v, epsilon_h, eta_parallel, delta, omega


def epsilon_v_only_op(v, grad_sq):
    """ε_V = ½|∇V|²/V² (anguelova.rs:138-140 — the ½ IS present here)."""
    return 0.5 * grad_sq / v**2


def consistency_rapidturn_only_op(v, v00, v10, v11):
    """Original AL rapid-turn condition (anguelova.rs:143-154):
    lhs = V_ww/V, rhs = 3 (V_vw/V_vv)², out = ||lhs|−|rhs||/(|lhs|+|rhs|)."""
    lhs = v11 / v
    rhs = 3.0 * (v10 / v00) ** 2
    return _ratio_metric(torch.abs(lhs) - torch.abs(rhs), lhs, rhs)


def consistency_only_op(v, v00, v10, v11):
    """Generalised condition (anguelova.rs:157-163):
    lhs = V_ww/V − 3, rhs = 3 (V_vv/V_vw)² + (V_vv/V)(V_vw/V_vv)²."""
    lhs = v11 / v - 3.0
    rhs = 3.0 * (v00 / v10) ** 2 + (v00 / v) * (v10 / v00) ** 2
    return _ratio_metric(torch.abs(lhs) - torch.abs(rhs), lhs, rhs)


def flag_quantum_diff_op(grad_components, accuracy):
    """Saddle-point mask: True where every |∂_a V| ≤ accuracy."""
    mask = None
    for g in grad_components:
        m = torch.abs(g) <= accuracy
        mask = m if mask is None else torch.logical_and(mask, m)
    return mask
