#!/usr/bin/env python3
"""Drive inflatox_torch's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py [--parent DIR]

Needs one CUDA device, the CUDA toolkit (nvcc) and this checkout; builds the
kernels (B1 and B5: the grid-scan library; B6: the solver library; B8 alone:
the special-function library) from
``inflatox_torch/csrc`` into ``build/inflatox_torch_kernels/`` on first use,
one nvcc per library, all started together.  Phases, each of which either
passes or ends the script with a nonzero exit:

1. environment: torch, CUDA, nvcc, sympy, card name and power limit;
2. build: the hyperinflation, angular and 3-field models through
   ``models`` → ``Compiler``, ``GeneralisedAL(device="cuda")``, and the
   kernels' build times;
3. golden values of tests/test_doc.py (calc_V, calc_H);
4. the grid-scan path: ``complete_analysis`` at 4096² through the default
   engine (kernel B1), held against the plain PyTorch version on the card
   and, for rows 0-63, on the CPU (rtol 5e-10, identical NaN/±inf masks),
   then again at the README's 1000²;
5. a second model (angular) at 1024², through the same comparisons;
6. timing at 4096²: CUDA events over chained launches, kernel and plain
   version in turns (plain, kernel, kernel, plain); the kernel's device time
   from torch.profiler; the user-facing call on the host clock;
7. the solver library's first-use build and ptxas's registers and spills
   for 2 and 3 fields;
8. the background path (kernel B6) at cfg5d's full width: hyperinflation,
   4096 trajectories × 2000 rows, RKF45, through ``solve_eom_batch``;
   held against the plain version on the card (rtol 1e-12, identical NaN
   masks) and, for trajectories 0-63, on the CPU; then per-trajectory
   masses, RK4 at 4096 × 500 and a 3-field model at 1024 × 500;
9. the on-trajectory path (kernel B5): ``complete_analysis_ot`` and the
   three single-output kinds over all 8,192,000 solved points of phase 8,
   against the plain version on the card (rtol 5e-10, identical masks) and,
   for the first 4096 points, on the CPU;
10. the basin survey at cfg5e's size (4096 initial conditions × 2000 rows)
    through the default engine against ``engine="torch"`` on the card;
11. timing of B6 and B5 against their plain versions (CUDA events, in
    turns), and their device times from torch.profiler;
12. the raw surfaces at the JAX package's cfg0 size: ``calc_V_array`` and
    ``calc_H_array`` on hyperinflation at 8000² (kernel B1's ``potential``
    and ``hesse`` kinds; ``calc_V_array`` also at ``precision="f32"``,
    kernel B2) and ``flag_quantum_dif`` at 4096² (the ``gradient`` kind),
    each against its plain version on the card (f64 rtol 5e-10, f32 1e-5)
    and, for rows 0-63, on the CPU;
13. the fp32 engine: hyperinflation ``complete_analysis`` at 4096² on B2
    (cfg1's fp32 twin), the share within rtol 1e-5 of the plain f32 version,
    all within it where the f32 and f64 plain versions agree within 1e-4;
14. D5 ``complete_analysis`` at 1024² over cfg4's extent on B1 (the TPU's
    range-extended engine maps onto f64), rtol 5e-10, and ε_V's finite share;
15. EGNO ``consistency_rapidturn`` and ``complete_analysis`` at 2048² on
    cfg3's window at ``precision="dd"`` (kernel B4), rtol 5e-10 against the
    double-double plain version; at 64 grid points V, V_vv, V_wv, V_ww and
    |∇V|² from the kernel within 1e-14 of 40-digit mpmath, f64's error
    beside them;
16. kernel B5b: the four on-trajectory scans at ``precision="dd"`` over
    1,048,576 points spread over the EGNO window, rtol 5e-10;
17. timing of B2, B4, B5b and B1's new kinds against their plain versions
    (the grid kernels, here and in phases 18-19, launched through the
    library's C entry with parameters and output made beforehand, so that
    the wrapper's host work per call does not set the pace);
18. the parameter sweep at bench cfg5's size (hyperinflation, 32 masses,
    512²) through ``parallel.parameter_sweep`` (one launch of kernel B7a),
    against the plain version on the card (rtol 5e-10, identical masks),
    each set bit for bit against a single B1 scan, sets 0-3 against the
    plain version on the CPU; then cfg5's on-device min-consistency
    reduction against the full maps';
19. the same sweep in f32 (kernel B7b, rtol 1e-5), EGNO's rapid-turn
    condition over 8 values of c at 512² in double-double (kernel B7d), and
    ``flag_quantum_dif`` over cfg5's sweep, exact;
20. kill and resume (bench cfg5c, on the port): a worker process
    (``chip_smoke.py --sweep-worker``) runs a checkpointed sweep with the
    (min, argmin) reduction at 512², chunk 32, sized from the checkpointed
    rate to last about 3 s on the card; it is SIGKILLed once 40 % of the
    chunks exist, the sweep resumed to completion in this process, and the
    result held exactly against an uncheckpointed sweep;
21. timing of B7a (also against 32 chained B1 launches, through the
    wrapper and through the C entry alone), B7b and B7d, and of
    ``parameter_sweep`` on the host clock: with and without a reduction,
    checkpointed or not.  (``scripts/probe_sweep_pipeline.py`` compares the
    chunk loop's orders of copy and write.)

22. kernel B8 (``csrc/special.cuh``, the special functions) alone, through
    ``csrc/special_eval.cu``: each of the 15 functions over 2^24 arguments
    spanning its range, at integer orders 0, 1, 5 and −2, fractional
    0.3, 2.5, 12.7, 29.9, −12.7, ±30.5 and 35.3 (NaN), spherical 0-8, 2.3 and
    2.5, and tests/test_special.py's hypergeometric parameters; in f64
    against the plain version on the card (``lowering/special.py``: rtol
    5e-10, identical NaN/±inf masks, the bit-identical share reported) and
    in f32 (within 1e-5 of the largest value's 1e-3, identical masks), both
    on the first 2^21 arguments, which begin with every route's branch
    points, their neighbours, NaN, ±0 and ±inf; 64 points per case against
    40-digit mpmath at tests/test_special.py's tolerances; each timed on
    its arguments in random order and sorted (a warp whose lanes take
    different routes runs each), beside the torch.special call that
    computes it, where there is one, timed the same two ways; the cases'
    numbers as one ``B8 cases:`` JSON line;
23. S1 (bench cfg4b's 1F1 + 2F1 + erf·Γ potential at 1024² on its extent,
    nothing cut), S2 (a·J₀(x)² + K₁(x+2)·y² + 2) and S3 (a·J_{3/10}(x)² +
    K_{5/2}(x+2)·y² + 2) at 1024²: ``complete_analysis`` in f64 (kernel B1)
    and f32 (B2), each launch counted as one that ran B8, against the plain
    version on the card (f64 rtol 5e-10; f32 as phase 13) and, for rows 0-63,
    on the CPU (rtol 1e-6: the CPU's lgamma, erf, exp, log, sin and cos part
    from CUDA's in the last bit, the maps amplify it), and V, the Hesse and
    |∇V|² at 64 points against 40-digit mpmath (1e-11); S1's
    ``calc_V_array``/``calc_H_array``; ``precision="dd"`` on S1 must raise,
    naming the function;
24. kernel B5a (the fused point functions, B8 inside, after the coherence
    pass that sorts the points by a coarse cell): the four on-trajectory
    kinds over 1,048,576 points of S1's, S2's and S3's windows; S3's
    complete_analysis also on the same points sorted by x[0], its outputs
    permuted back bit for bit the random order's, both timed in turns and
    their ratio printed (a warp whose lanes take different B8 routes runs
    each), and without the coherence pass;
25. kernel B6 with B8 in its derivative: S2, RKF45, 4096 trajectories ×
    2000 rows from initial fields spread over its extent, the first 20 rows
    against the plain version on the card (rtol 1e-12) and trajectories
    0-63 on the CPU (its derivative runs some 6,000 torch operations: the
    plain version is cut to those rows);
26. S1's sweep over 8 values of a at 512², f64 (B7a) and f32 (B7b), each set
    bit for bit its single scan;
27. C9's Piecewise and sinc models at 1024² through B1, B2 and B4, each
    against its plain version;
28. geometry, observables and fitting on the card (``inflatox_torch.
    geometry``, ``observables``, ``utils.profiling``): the α-attractor's
    background, 3000 rows of RKF45 on kernel B6, then ``horizon_exit``,
    ``power_spectrum``, ``cobe_normalize`` and ``n_star_matching`` on the
    card, each against the same call with ``device="cpu"`` on the same rows
    (rtol 1e-12), and the COBE round trip (M⁴ rescaled, re-solved on B6,
    P_ζ within 1e-4 of 2.1e-9); ``slow_roll`` over cfg1's hyperinflation
    4096² grid (rows 0-63 against the CPU, 1e-12); ``Geometry`` over a
    4096² grid of the hyperbolic plane (R = −2 within 1e-12, Γ and the
    Riemann tensor against their closed forms, rows 0-63 of every surface
    against the CPU); ``observable_jacobian`` and ``fisher_matrix`` on
    hyperinflation, S2 and the α-attractor's pivot against the CPU;
    ``solve_eom_fixed`` over a 2000-point grid (rows against the CPU, a
    directional gradient against central differences of the same
    function on the CPU, forward and backward timed, kernel launches a step counted); a 64-start
    ``fit_parameters`` of the α-attractor's (c, α) over 300 steps, its
    history against the CPU's; a ``profiling.trace`` around one B1
    ``complete_analysis`` at 4096² in a fresh process (``chip_smoke.py
    --trace-worker DIR``), whose exported trace must name B1's kernel.  Its models build in phase 2, the α-attractor's B6 library with
    the others;
29. perturbation spectra on the card (``inflatox_torch.perturbations``) at
    the JAX package's bench sizes: cfg6, ``delta_n_sweep`` on bench's
    quadratic model over 16 mass sets × 8 pivots (two B6 launches, 16 then
    512 trajectories × 2000 rows; median of 3 on the host clock, the
    perturbed launch alone, the copy of its rows), against the plain solver
    on the CPU (first-order outputs rtol 1e-6); cfg6b and cfg6c,
    ``mode_sweep`` and ``transport_sweep`` over 8 sets × 8 pivots at 4000 +
    1500 RK4 steps, against ``device="cpu"`` on the same base rows (rtol
    1e-10); each integrator's kernel launches and ms a step; the curved
    two-field model of tests/test_perturbations.py (3000 RKF45 rows on B6):
    ``delta_n_spectrum(order=2)``, ``mode_spectrum`` and
    ``transport_spectrum`` at 12 pivots and ``squeezed_fnl``, each against
    ``device="cpu"`` (``N_hess``, ``f_NL``, ``f_NL_sq`` rtol 1e-4), mode
    against δN within 8 % and Maldacena's relation within 5 %.  Its two B6
    libraries build in phase 2; the B6 row of the kernel table counts its
    launches.
30. posterior sampling on the card (``inflatox_torch.inference``), no
    kernel of its own (B1-B8's counts must not move): examples/posterior.py's
    log-posterior (the quadratic model, (n_s, r) pseudo-data, the Gaussian
    prior) with its value and gradient at three masses, and one HMC and one
    NUTS transition of 4 chains from one pre-drawn block, each against
    ``device="cpu"`` (rtol 1e-12); ms a transition on the card and on the
    CPU (host clock, median of 3 runs of ``POST_TIMED``); launches a density evaluation
    and a transition and the device's idle share from torch.profiler in a
    fresh process (``chip_smoke.py --trace-worker DIR posterior``); the
    density's batching route; examples/posterior.py's workload (4 chains,
    24 leapfrog steps, ``POST_WARMUP`` + ``POST_SAMPLES`` transitions, cut
    from 1000 + 3000, the standard errors printed) held to the port's
    Fisher forecast at tests/test_inference.py:92's tolerances, and NUTS on
    its correlated Gaussian (:44) at that test's tolerances
    (``NUTS_WARMUP`` + ``NUTS_SAMPLES`` transitions, cut from 600 + 1500).  Prints a
    ``phase 30 summary:`` JSON line.
31. many devices (``inflatox_torch.parallel``) on the card, no kernel of
    its own: meshes (a) ``make_mesh()``, the card as one slot, and (b) four
    slots on cuda:0 (a 6-row grid over them must raise; its solves and
    survey take 4093 trajectories and its sweep 31 sets, the padding
    paths); ``sharded_scan`` of cfg1 in f64 (B1) and f32 (B2) and of EGNO
    at 2048² in double-double (B4), ``sharded_scan_ot`` over phase 8's 8.19
    M points (B5a), ``sharded_solve_eom_batch`` at cfg5d with shared and
    per-trajectory masses (B6), ``parameter_sweep(mesh=)`` at cfg5 (B7a),
    ``survey_initial_conditions(mesh=)`` at cfg5e, each bit for bit the
    unsharded call, launched once a slot (counted), cfg1's rows 0-63 and
    cfg5d's trajectories 0-63 also against the CPU; the spectra of phase
    29's quadratic model (one set, 8 pivots, the RK4 loops at 1000 + 500
    steps) and ``sample_posterior`` on phase 30's model (4 chains, 10 + 10
    transitions) over a 2-slot mesh (rtol 1e-12; the draws bit for bit);
    then (c) two ``chip_smoke.py --dist-worker ADDRESS RANK`` processes
    sharing cuda:0 through ``distributed.initialize`` (gloo), each rank's
    gathered cfg1 scan and cfg5d solve bit for bit its single-device call.
    Sharded and unsharded times side by side (CUDA events over chained
    calls for the kernel paths, the host clock for the user-facing calls)
    and a ``phase 31 summary:`` JSON line;
32. the port's seven examples (``examples/torch_*.py``), each in this
    process through its ``main(["--device", "cuda"])`` at its full sizes
    after the launch counts are set to 0 (``scripts/time_examples.py``;
    their kernel libraries build with the others in phase 2): its own
    asserts, its wall time on the host clock, its kernel launches by
    kernel, failing when a kernel its table names (quickstart B1, B6, B7a;
    engines tour B1, B2, B4; special functions B1 with B8 inside;
    background sweep B6, B5a; fit B1; spectra B6; pipeline B1, B6) was
    launched no time; then the port's C oracle (``inflatox_torch.native``)
    for hyperinflation on the card's host: cfg1 at 4096² fused and
    reference-style, points a second beside kernel B1's, and B1's maps
    against the oracle's with identical NaN/±inf masks: rows 0-63 at rtol
    5e-10, the whole map at 5e-10 except where the map is not settled by
    its inputs' last bit (a one-ulp move of the extent moves B1's value by
    more than 5e-11; at most 1e-4 of the values); a ``phase 32 summary:``
    JSON line.

The point paths' bounds (B5a on phases 9 and 24, B5b on phase 16) count
each distinct operation of the kind's fused point function once (the least
work any point kernel must do; B8's operations on the run's points, each
distinct special call once), the count over the three model functions as
before printed beside.  With ``--parent DIR`` (the parent commit unpacked,
e.g. ``git archive``) the parent tree's grid-scan libraries for those
paths build with the others in phase 2, and after phase 28 each point path
runs the parent's kernel and this one through their C entries, bit for bit
equal, in turns (parent, this, this, parent).

Phase 11 takes the plain solver's time from phase 8's call instead of
timing it twice more; it also prints the attribution of B6's time per
attempt (``scripts/probe_solver_chain.py``'s instrumented copy of the
solver, built with the libraries in phase 2).  Phase 2 prints ptxas's
registers and spills for every library and for each point-scan instance; phases 17 and 21 print the
operation bounds of B4, B7d and B1 on D5 counted both ways (every point
evaluating whole model functions, and the staged kernel's row, column and
point stages), and the end of the run each kernel's time beside its time
before the staged grid kernel and the flat-loop solver (PERF.md).

Every phase requires identical NaN/±inf masks.  The last lines are the
kernel table (JSON), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import ast
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

RTOL = 5e-10  # the repo's tolerance for the analysis maps
RTOL_SOLVER = 1e-12  # kernel B6 against its plain version on the card
# B6 against the plain version on the CPU.  The CPU's libm (torch's
# vectorised pow) and CUDA's differ in the last bit now and then; one such
# bit in a step size moves every later row of that trajectory a little.
# The times stay close (1.9e-10 relative at cfg5d); so does the state while
# H > 0, measured against each component's largest value along its
# trajectory (velocities cross zero); once H < 0 the term -3Hχ pumps every
# difference up with the velocities (3.2e-3 after 2000 rows)
RTOL_CPU_TIMES = 1e-8
RTOL_CPU_PHYSICAL = 1e-6
RTOL_CPU_ALL = 1e-2
N_TIMED = 20  # chained calls per timing window of the plain version
N_TIMED_KERNEL = 200  # chained launches per kernel window (~0.1 s of work)
DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)  # bench cfg1 extent
README_EXTENT = (0.0, 2.5, 0.0, 3.141592653589793)
ANGULAR_EXTENT = (-0.7, 0.7, -0.7, 0.7)  # inside the unit disc
GOLDEN_V = 1.9166666666666667  # tests/test_doc.py
GOLDEN_H = [[0.41206897, -1.05517241], [-1.05517241, -0.07873563]]
B_SOLVE, STEPS = 4096, 2000  # bench cfg5d / cfg5e
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F64_OPS_PER_S = 33.5e12  # H100 SXM f64 outside the tensor cores
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# operations of the complete-analysis point tail (csrc/anguelova.cuh), fabs
# and comparisons not counted; of the rapid-turn tail
TAIL_OPS = 41
RAPIDTURN_TAIL_OPS = 8
RTOL_F32 = 1e-5  # kernel B2 against its plain f32 version
RTOL_MPMATH = 1e-14  # B4's model functions against 40-digit mpmath
CFG0_N = 8000  # the reference's calc_V_array default (bench.py cfg0)
EGNO_EXTENT = (0.46, 0.50, 0.0, 3.141592653589793)  # bench.py cfg3
EGNO_ARGS = {"m": 1e-3, "a": 0.5, "c": 1000.0, "alpha": 1.0}
D5_EXTENT = (0.1, 36.0, 0.0, 4 * 3.141592653589793)  # bench.py cfg4
D5_ARGS = {"V0": -1.17e-8, "N": 1000.0, "g_s": 0.01, "l_s": 501.961, "u": 50 * 501.961,
           "q": 1.0, "p": 5.0, "a0": 0.001, "a1": 0.0005, "b1": 0.001}
# f64 operations of one double-double operation in csrc/dd.cuh (add: two
# TwoSums and two quick ones; mul: FMA TwoProd; div: three quotient digits)
DD_OPS = {"add": 20, "mul": 9, "div": 70, "sqrt": 33, "exp": 676, "log": 726, "demoted": 2}
SWEEP_SETS, SWEEP_N = 32, 512  # bench cfg5: 32 masses × 512²
EGNO_SWEEP_C = (900.0, 1100.0, 8)  # 8 values of c around EGNO_ARGS' 1000
REHEARSAL_CHUNK = 32  # bench cfg5c's sweep at 512², chunk 32
REHEARSAL_WORKER_S = 3.0  # the worker's sweep lasts at least this long on the card
REHEARSAL_KILL_AT = 0.4  # share of the chunk files at which the worker is killed
# kernel times before the staged grid kernel and the flat-loop solver (the
# parenthesised times of PERF.md §5; NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's
BEFORE_MS = {"grid_scan_b1": 0.3874, "points_scan_b5": 0.1934, "solver_b6_rkf": 15.03,
          "solver_b6_rk4": 6.694, "grid_scan_b1_potential_8000": 0.1662,
          "grid_scan_b1_hesse_8000": 0.6294, "grid_scan_b1_gradient_4096": 0.0867,
          "grid_scan_b2_f32_potential_8000": 0.1691,
          "grid_scan_b2_f32_complete_analysis_4096": 0.2264, "grid_scan_b1_d5_1024": 0.2486,
          "grid_scan_b4_dd_egno_consistency_rapidturn_2048": 5.787,
          "grid_scan_b4_dd_egno_complete_analysis_2048": 8.366,
          "points_scan_b5b_dd_egno_1048576": 1.960, "grid_scan_b7a_sweep_32x512": 0.1961,
          "grid_scan_b7b_f32_sweep_32x512": 0.1170, "grid_scan_b7d_dd_egno_sweep_8x512": 2.880}
# phases 22-27: kernel B8 (the special functions) alone and on the main paths
SF_N = 1 << 24  # arguments per function in phase 22
SF_PLAIN_N = 1 << 21  # the prefix held against the plain version (its Steed
# routes run ~9,000 torch operations over the whole vector)
SF_COUNT_N = 1 << 14  # arguments whose routes' operations are counted for the bound
SF_MP_POINTS = 64  # points per function and per model against 40-digit mpmath
# the branch points of B8's routes, at the head of each phase-22 vector with
# their neighbours (J/Y's rational form to 5, K's series to 2, I's to 8,
# Steed's Temme/CF2 at 2 and Hankel beyond 40, 1F1's direct/Kummer at 0, the
# domains' edges at ±1, 300 and -32, ψ's shift to 16)
SF_EDGES = (0.0, 1.0, 2.0, 5.0, 8.0, 16.0, 40.0, 300.0, -1.0, -32.0)
SPECIAL_N = 1024  # S1-S3 grids (bench cfg4b's 1024², nothing cut)
S1_EXTENT = (0.3, 2.0, 0.2, 1.2)  # bench cfg4b
S2_EXTENT = (0.5, 3.0, 0.2, 1.5)  # tests/test_df32_special.py's Bessel models
SPECIAL_ARGS = [2.0]
SPECIAL_POINTS = 1 << 20  # B5a over S1's and S3's windows
SPECIAL_SOLVE_ROWS = 20  # rows of S2's solves held against the plain version
PIECEWISE_EXTENT = (-1.5, 1.5, -1.0, 1.1)
# the special-function models' maps against their plain version on the CPU:
# the CPU's lgamma, erf, exp, log, sin and cos (torch's own) part from CUDA's
# in the last bit now and then, and the maps' cancellations amplify it
CPU_RTOL_SPECIAL = 1e-6
SPECIAL_SWEEP_SETS = 8
# phase 28: geometry, observables and fitting
CMB_STEPS = 3000  # the α-attractor's background (tests/test_observables.py:382-410)
RTOL_CMB = 1e-12  # phase 28's functions on the card against device="cpu"
GEO_N = 4096  # slow roll and geometry grids (bench cfg1's 4096²)
HYPERBOLIC_EXTENT = (0.4, 2.0, -1.0, 1.0)
FIXED_POINTS, FIXED_T = 2000, 1.5  # solve_eom_fixed's time grid
FIXED_COUNT_POINTS = 101  # the grid whose kernel launches are counted
FIT_STARTS, FIT_STEPS = 64, 300
# phase 29: perturbation spectra, at the JAX package's bench sizes
SPECTRA_KW = {"pivots": 8, "N_margin_start": 5.0, "N_margin_end": 8.0,
              "steps": 2000}  # bench cfg6/6b/6c (bench.py:1105-1182)
DN_SETS, MODE_SETS = 16, 8  # cfg6's 16 mass sets; cfg6b's and cfg6c's 8
CURVED_STEPS = 3000  # tests/test_perturbations.py:34-48's curved background
# δN on kernel B6 against the plain solver on the CPU: solve differences of
# ~1e-11 in N give ~1e-7 on N_grad at h = 1e-4 (tests/test_perturbations.py:
# 204-226's budget); second differences at h2 = 2e-3 amplify by 1/h2²
RTOL_DN_FIRST = 1e-6
RTOL_DN_SECOND = 1e-4
# the mode and transport routes, card against device="cpu" on the same base
# rows (torch ops alone); cos Δ and T_RS, zero in exact arithmetic on the φ²
# axis, also within 1e-12 absolute
RTOL_SPECTRA = 1e-10
FLOOR_SPECTRA = 1e-12
STEPS_COUNTED, STEPS_TIMED = 100, 1000  # RK4 steps of each integrator
# phase 30: posterior sampling, examples/posterior.py's workload
POST_X, POST_THETA = [14.0, 6.0], [1.0, 0.7]  # the pivot and the fiducial masses
POST_SIGMA, POST_PRIOR_SIG = {"n_s": 0.004, "r": 0.01}, 0.05
POST_CHAINS, POST_LEAPFROG, POST_SEED = 4, 24, 0
# examples/posterior.py takes 1000 + 3000 transitions and the NUTS test 600 +
# 1500: ~450-650 s and ~40 s at the 100-165 ms and ~19 ms a transition
# measured on the card (PERF.md §5), over phase 30's ~180 s; cut, the
# standard errors printed.  200 + 300 since phase 32 joined (200 + 400
# before): the whole run took ~1,150 s on a slower card host
POST_WARMUP, POST_SAMPLES = 200, 300
POST_CUT = "; cut from examples/posterior.py's 1000 + 3000"
RTOL_POSTERIOR = 1e-12  # the card against device="cpu"
POST_TIMED, POST_COUNTED = 10, 3  # transitions a timed run (20 before phase 32); a profiled run
# NUTS on the correlated Gaussian of tests/test_inference.py:44
GAUSS_COV = [[1.0, 0.6, 0.0], [0.6, 2.0, 0.3], [0.0, 0.3, 0.5]]
GAUSS_MEAN = [1.0, -2.0, 0.5]
# cut from the test's 600 + 1500 (300 + 750 before phase 32)
NUTS_WARMUP, NUTS_SAMPLES, NUTS_DEPTH = 200, 500, 7
# phase 31: many devices (meshes of the port's parallel package)
MESH_SLOTS = 4  # mesh (b): four slots on cuda:0
MESH_CFG1_N, MESH_EGNO_N = 4096, 2048  # bench cfg1's grid; EGNO's (cfg3)
MESH_SOLVE_B = 4093  # mesh (b)'s solves and survey: cfg5d's 4096 less 3, not a multiple of 4
MESH_SWEEP_SETS = 31  # mesh (b)'s sweep: cfg5's 32 less 1
MESH_SOLVE_TIMED = 10  # chained sharded solves a timing window
SPECTRA_MESH_SLOTS = 2  # the spectra's and the posterior's mesh
# the mode and transport loops at 1000 + 500 RK4 steps (phase 29's 4000 +
# 1500 cut: the loops are launch-bound, and the sharded call runs one
# loop a slot)
MESH_SPECTRA_STEPS = {"dense_steps": 1000, "tail_steps": 500}
RTOL_MESH_SPECTRA = 1e-12  # the RK4 loops' batched products round with the batch
MESH_POST_WARMUP, MESH_POST_SAMPLES = 10, 10  # 20 + 20 before phase 32
DIST_TIMEOUT_S = 300  # each --dist-worker process
HERE = os.path.dirname(os.path.abspath(__file__))
PROFILE_DIR = os.path.join(HERE, "build", "chip_smoke_profile")  # under .gitignore's build/
SWEEP_DIR = os.path.join(HERE, "build", "chip_smoke_sweep")  # under .gitignore's build/


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def point_instances(log):
    """{kind: (registers, spill bytes: stores + loads)} of each point-scan
    kernel instance (``points_scan_kernel<KIND>``, and the special-function
    models' ``points_coherent_kernel<KIND>`` as "<kind> coherent") in an
    nvcc log of ``-Xptxas=-v``, kinds by name
    (inflatox_torch.ops.cuda_kernels.KINDS)."""
    from inflatox_torch.ops.cuda_kernels import KINDS

    names = {kind_id: kind for kind, (kind_id, _) in KINDS.items()}
    out, entry, props, spills = {}, None, None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props is not None:
            spills[props] = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            kind = re.search(r"points_(scan|coherent)_kernelILi(\d+)E", entry)
            if kind:
                label = names[int(kind.group(2))] + (" coherent" if kind.group(1) == "coherent"
                                                     else "")
                out[label] = (int(m.group(1)), spills.get(entry, 0))
            entry = None
    return out


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout or out.stderr).strip()


def compare(got, want, rtol=RTOL):
    """(max relative error, max absolute error, share bit-identical) of two
    tensors on one device; raises unless the NaN and ±inf masks are
    identical and every finite value is within rtol (atol 0; an infinite
    rtol only reports)."""
    import torch

    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(mask(got), mask(want)), f"{mask.__name__} masks differ")
    finite = torch.isfinite(want)
    diff = (got - want).abs()
    scale = want.abs()
    check(rtol == float("inf") or bool((diff[finite] <= rtol * scale[finite]).all()),
          f"values differ beyond rtol {rtol}")
    nonzero = finite & (scale > 0)
    rel = (diff[nonzero] / scale[nonzero]).max().item() if nonzero.any() else 0.0
    absolute = diff[finite].max().item() if finite.any() else 0.0
    same = ((got == want) | (torch.isnan(got) & torch.isnan(want))).double().mean().item()
    return rel, absolute, same


def nanmax(t):
    import torch

    return t[~torch.isnan(t)].max().item()


def scan_and_check(al, art, args, extent, n, label):
    """The grid-scan path at n² plus its comparisons; returns (maps,
    launches, max abs error against the plain version on the card)."""
    import torch

    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_kernels import evaluate_points
    from inflatox_torch.ops.grid import axis_coords

    reset_counts()
    maps = al.complete_analysis(args, *extent, n, n, progress=False, output="f64_device")
    torch.cuda.synchronize()
    launches = cuda_kernels.launches()
    check(launches > 0, f"{label}: the main path launched no kernel")
    maps = torch.stack(maps)
    check(maps.shape == (6, n, n) and maps.dtype == torch.float64,
          f"{label}: maps of shape {tuple(maps.shape)}, {maps.dtype}")
    check(nanmax(maps[0]) <= 1.0, f"{label}: nanmax(consistency) > 1")
    check(bool(torch.isfinite(maps).any()), f"{label}: no finite value")

    plain = torch.stack(al.complete_analysis(args, *extent, n, n, progress=False,
                                             engine="torch", output="f64_device"))
    rel, absolute, same = compare(maps, plain)
    print(f"{label}: launches={launches} kernel vs plain torch on the card: "
          f"max_rel={rel:.3e} max_abs={absolute:.3e} bit_identical={same:.6f}")

    rows = 64
    x0 = axis_coords(extent[0], extent[1], n)[:rows].reshape(rows, 1).expand(rows, n)
    x1 = axis_coords(extent[2], extent[3], n).reshape(1, n).expand(rows, n)
    cpu = evaluate_points(art, "complete_analysis", args, (x0, x1))
    rel, absolute_cpu, same = compare(maps[:, :rows].cpu(), cpu)
    print(f"{label}: kernel rows 0-{rows - 1} vs plain torch on the CPU: "
          f"max_rel={rel:.3e} max_abs={absolute_cpu:.3e} bit_identical={same:.6f}")
    return maps, launches, absolute


def time_ms(fn, n=N_TIMED, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def in_turns(kernel, plain, n_kernel, n_plain, plain_warmup=3):
    """Mean ms of kernel and plain version, timed plain, kernel, kernel,
    plain; returns (kernel ms, plain ms, the four windows)."""
    plain_a = time_ms(plain, n_plain, plain_warmup)
    kernel_a = time_ms(kernel, n_kernel)
    kernel_b = time_ms(kernel, n_kernel)
    plain_b = time_ms(plain, n_plain, 0)
    return (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2, (kernel_a, kernel_b,
                                                                 plain_a, plain_b)


def profiled_ms(fn, name, n):
    """Device time per launch of the kernels whose name holds ``name``, from
    torch.profiler, as text: "not measured" when the trace has no device
    time for them, with the events the trace does hold."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages if name in e.key]
    device_us = sum(getattr(e, "device_time_total", 0) for e in events)
    count = sum(e.count for e in events)
    if count and device_us:
        return f"{device_us / count / 1e3:.4f} ms"
    held = "; ".join(f"{e.key[:60]} x{e.count} {getattr(e, 'device_time_total', 0):.0f} us"
                     for e in list(averages)[:4])
    return f"not measured (trace holds: {held or 'nothing'})"


def bound(n_bytes, n_ops, ops_per_s=F64_OPS_PER_S):
    """(least ms, what bounds it) for moving n_bytes and doing n_ops
    operations (f64 by default) on one H100."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------------- #
# operation counts, from the lowered model functions the kernels translate  #
# ------------------------------------------------------------------------- #


def _node_ops(node):
    """f64 operations one evaluation of an expression node does: each binary
    operation and each library call counts one, an integer power its
    multiplies by repeated squaring; negations and subexpressions of
    constants only are not counted (the compiler folds them)."""
    if not any(isinstance(n, (ast.Name, ast.Subscript)) for n in ast.walk(node)):
        return 0
    if isinstance(node, ast.BinOp):
        return 1 + _node_ops(node.left) + _node_ops(node.right)
    if isinstance(node, ast.UnaryOp):
        return _node_ops(node.operand)
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Name) and func.id == "_ipow":
            exponent = abs(ast.literal_eval(node.args[1]))
            mults = exponent.bit_length() - 1 + bin(exponent).count("1") - 1
            negative = ast.literal_eval(node.args[1]) < 0
            return _node_ops(node.args[0]) + mults + int(negative)
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "_special"):  # B8's own: special_ops, on the data
            return sum(_node_ops(a) for a in node.args)
        if isinstance(func, ast.Attribute) and func.attr == "where":
            return sum(_node_ops(a) for a in node.args)
        return int(not (isinstance(func, ast.Name) and func.id == "float")) + sum(
            _node_ops(a) for a in node.args)
    if isinstance(node, ast.Compare):
        return _node_ops(node.left) + sum(_node_ops(c) for c in node.comparators)
    return 0


def lowered_ops(lowered, outputs=None):
    """Operations of a lowered function: its CSE assignments and the
    returned outputs listed in ``outputs`` (all when None)."""
    (fn,) = ast.parse(lowered.source).body
    total = 0
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign):
            total += _node_ops(stmt.value)
        elif isinstance(stmt, ast.Return):
            value = stmt.value
            elts = value.elts if isinstance(value, ast.Tuple) else [value]
            chosen = elts if outputs is None else [elts[k] for k in outputs]
            total += sum(_node_ops(e) for e in chosen)
    return total


def point_ops(art, special=0.0):
    """Operations per point of the complete-analysis kind (B1, B5): V, the
    Hesse (f_hesse computes all four components), |∇V|² and the tail; and
    ``special``, kernel B8's operations per point on the run's points
    (:func:`special_ops`), which a model that calls special functions must
    give."""
    check(special > 0 or not art.uses_special_functions,
          "point_ops: a special-function model needs its B8 operations")
    return (lowered_ops(art.potential) + lowered_ops(art._hesse)
            + lowered_ops(art.grad_square) + TAIL_OPS + special)


def special_ops(fns, *inputs):
    """Kernel B8's operations that the lowered functions ``fns`` need at
    each point of ``inputs`` (their arguments: coordinates, then velocities
    or parameters), summed over ``fns``: for each special call only the
    route its argument takes and the loop steps before it converges
    (``special.route_operations``).  Returns an int64 tensor of the
    points' shape."""
    from inflatox_torch.lowering.special import route_operations, suppress_domain_warnings

    total = 0
    with suppress_domain_warnings():
        for fn in fns:
            total = total + route_operations(fn, *inputs)[1]
    return total


class _MemoSpecial:
    """The special-function module as the lowered functions see it, each
    call that repeats an earlier one (the same function, equal arguments)
    answered with that call's result, as a fused point function makes
    each distinct call once."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __getattr__(self, name):
        import torch

        fn = getattr(self.module, name)

        def same(a, b):
            if torch.is_tensor(a) or torch.is_tensor(b):
                return (torch.is_tensor(a) and torch.is_tensor(b) and a.shape == b.shape
                        and bool(torch.equal(a, b)))
            return a == b

        def call(*args):
            for (other, other_args), value in self.calls:
                if other == name and len(other_args) == len(args) and all(
                        map(same, other_args, args)):
                    return value
            value = fn(*args)
            self.calls.append(((name, args), value))
            return value

        return call


def fused_special_ops(art, kind, *inputs):
    """Kernel B8's operations at each point of ``inputs`` (coordinates,
    parameters) in the fused point function of ``kind``: the model values
    the kind's tail reads (V, V_vv, V_wv, V_ww, |∇V|², as
    cuda_codegen._POINT_KINDS lists them), each distinct special call once,
    only the route its argument takes (``special.route_operations``)."""
    from inflatox_torch.lowering import special as sf
    from inflatox_torch.lowering.cuda_codegen import _POINT_KINDS

    uses = _POINT_KINDS[kind][0]
    fns = [getattr(art, attr) for key, attr in (("V", "potential"), ("hesse", "_hesse"),
                                                  ("gsq", "grad_square")) if key in uses]
    memo = _MemoSpecial(sf)
    spaces = [fn.fn.__globals__ for fn in fns]
    for space in spaces:
        space["_special"] = memo

    def values(*a):
        out = []
        for fn in fns:
            got = fn(*a)
            out += [got[k] for k in (0, 2, 3)] if fn is art._hesse else [got]
        return tuple(out)

    try:
        with sf.suppress_domain_warnings():
            return sf.route_operations(values, *inputs)[1]
    finally:
        for space in spaces:
            space["_special"] = sf


def fused_point_ops(art, kind, precision="f64", special=0.0):
    """f64 operations per point of kernels B5a/B5b: each distinct operation
    of the kind's fused point function once (cuda_codegen.point_fn_ops; in
    double-double by DD_OPS), the tail, and ``special``, kernel B8's
    operations per point over the distinct calls (:func:`fused_special_ops`),
    which a model that calls special functions must give."""
    from inflatox_torch.lowering.cuda_codegen import point_fn_ops

    ops = point_fn_ops(art, kind, precision)
    check((ops.get("special", 0) > 0) == (special > 0),
          f"fused_point_ops: {ops.get('special', 0)} special calls, B8 operations {special}")
    weigh = sum((DD_OPS.get(k, 1) if precision == "dd" else 1) * v for k, v in ops.items()
                if k != "special")
    tail = {"complete_analysis": TAIL_OPS, "consistency_rapidturn": RAPIDTURN_TAIL_OPS}[kind]
    return weigh + tail + special


def grid_special_ops(art, kind, args, extent, n, device, precision):
    """Kernel B8's operations in one n × n grid launch of ``kind`` on its
    own coordinates.  Every special call of these models sits in a row or a
    column stage (checked), so the calls at the diagonal points (x0_i, x1_i)
    are each row's and each column's once."""
    import torch

    from inflatox_torch.lowering.cuda_codegen import _GRID_FUNCTIONS, grid_stage_ops

    counts = grid_stage_ops(art, precision)
    check(not any(counts[f]["point"].get("special") for f in KIND_FNS[kind]),
          "grid_special_ops: a special call in the point stage")
    dtype = torch.float32 if precision == "f32" else torch.float64
    x0a, x0b, x1a, x1b = extent
    i = torch.arange(n, dtype=torch.float64, device=device)
    xs = [(x0a + i * ((x0b - x0a) / n)).to(dtype), (x1a + i * ((x1b - x1a) / n)).to(dtype)]
    p = torch.tensor(args, dtype=dtype, device=device)
    attrs = dict((name, attr) for name, attr, _ in _GRID_FUNCTIONS)
    return int(special_ops([getattr(art, attrs[f]) for f in KIND_FNS[kind]], xs, p).sum())


def _dd_node_ops(node):
    """f64 operations of one node of a lowered function rewritten into
    double-double (inflatox_torch.lowering.dd_lowering), by DD_OPS;
    subexpressions of constants only are not counted."""
    if not any(isinstance(n, (ast.Name, ast.Subscript)) for n in ast.walk(node)):
        return 0
    if isinstance(node, ast.BinOp):
        op = {ast.Add: "add", ast.Sub: "add", ast.Mult: "mul", ast.Div: "div"}[type(node.op)]
        return DD_OPS[op] + _dd_node_ops(node.left) + _dd_node_ops(node.right)
    if isinstance(node, ast.UnaryOp):
        return _dd_node_ops(node.operand)
    if isinstance(node, ast.Call):
        func = node.func
        inner = sum(_dd_node_ops(a) for a in node.args)
        if isinstance(func, ast.Name) and func.id == "_ipow":
            exponent = abs(ast.literal_eval(node.args[1]))
            mults = exponent.bit_length() - 1 + bin(exponent).count("1") - 1
            negative = ast.literal_eval(node.args[1]) < 0
            return _dd_node_ops(node.args[0]) + mults * DD_OPS["mul"] + negative * DD_OPS["div"]
        if isinstance(func, ast.Attribute):
            name = {"pow": None, "sqrt": "sqrt", "exp": "exp", "log": "log"}.get(
                func.attr, "demoted")
            if name is None:  # exp(y log x)
                return inner + DD_OPS["log"] + DD_OPS["mul"] + DD_OPS["exp"]
            return inner + DD_OPS[name]
        return inner
    return 0


def dd_lowered_ops(lowered, outputs=None):
    """f64 operations of a lowered function evaluated in double-double."""
    from inflatox_torch.lowering.dd_lowering import dd_tree

    total = 0
    for stmt in dd_tree(lowered).body:
        if isinstance(stmt, ast.Assign):
            total += _dd_node_ops(stmt.value)
        elif isinstance(stmt, ast.Return):
            value = stmt.value
            elts = value.elts if isinstance(value, ast.Tuple) else [value]
            chosen = elts if outputs is None else [elts[k] for k in outputs]
            total += sum(_dd_node_ops(e) + 1 for e in chosen)  # + the demotion
    return total


def dd_point_ops(art, kind):
    """f64 operations per point of kernels B4/B5b: the double-double model
    functions the kind needs, then the f64 tail."""
    ops = dd_lowered_ops(art.potential) + dd_lowered_ops(art._hesse)
    if kind == "complete_analysis":
        return ops + dd_lowered_ops(art.grad_square) + TAIL_OPS
    return ops + RAPIDTURN_TAIL_OPS


#: the model functions of each kind, as the kernel's point stage runs them
KIND_FNS = {"complete_analysis": ("f_V", "f_hesse", "f_gsq"),
            "consistency_rapidturn": ("f_V", "f_hesse")}


def staged_ops(art, kind, precision, n0, n1, sets=1, special=None):
    """f64 operations of the staged grid kernel's work for one launch
    (inflatox_torch.lowering.cuda_codegen.grid_stage_ops): point stages at
    every point, row stages once per row and set, column stages once per
    column and set, then the tail at every point; in double-double each
    operation by DD_OPS.  ``special``: kernel B8's operations in the launch
    on its coordinates (:func:`grid_special_ops`), which a model that calls
    special functions must give."""
    from inflatox_torch.lowering.cuda_codegen import grid_stage_ops

    def weigh(ops):
        return sum((DD_OPS.get(k, 1) if precision == "dd" else 1) * v for k, v in ops.items()
                   if k != "special")

    counts = grid_stage_ops(art, precision)
    calls = sum(c.get("special", 0) for f in KIND_FNS[kind] for c in counts[f].values())
    check((calls > 0) == (special is not None),
          f"staged_ops: {calls} special calls, B8 operations {special}")
    total = (special or 0) + sum(
        weigh(counts[f]["point"]) * n0 * n1 * sets + weigh(counts[f]["row"]) * n0 * sets
        + weigh(counts[f]["col"]) * n1 * sets for f in KIND_FNS[kind])
    tail = TAIL_OPS if kind == "complete_analysis" else RAPIDTURN_TAIL_OPS
    return total + tail * n0 * n1 * sets


def attempt_ops(art, solver, special=0.0):
    """Operations of one adaptive attempt of kernel B6 (csrc/solver.cuh);
    ``special`` is kernel B8's operations per derivative on the solve's
    states (:func:`special_ops`), which a model that calls special functions
    must give."""
    from inflatox_torch.ops import cuda_solver as cs

    check(special > 0 or not art.uses_special_functions,
          "attempt_ops: a special-function model needs its B8 operations")
    n = art.n_fields
    ny = 2 * n + 1
    deriv = lowered_ops(art.eom) + lowered_ops(art.eom_hdot) + 2 * n + 1 + special

    def step(a, *bs):
        nonzero = int((a != 0).sum()) + sum(int((b != 0).sum()) for b in bs)
        return a.shape[0] * deriv + nonzero * (1 + 2 * ny)

    if solver == "rkf":
        body = step(cs._RKF_A, cs._RKF_B5, cs._RKF_B4)
    else:
        body = 3 * step(cs._RK4_A, cs._RK4_B) + 1
    # error norm, sqrt, controller (reciprocal, product, pow, ratio), t, dt
    return body + 3 * ny - 1 + 1 + 4 + 2


# ------------------------------------------------------------------------- #
# the background path                                                       #
# ------------------------------------------------------------------------- #


def solve_and_check(art, pars, f0, steps, solver, label, max_err=1e-6):
    """One batched solve through ``background.solve_eom_batch`` on the
    card, counted, then kernel vs plain version on the card and, for
    trajectories 0-63, on the CPU.  Returns a dict of what the timing and
    the kernel table need."""
    import numpy as np
    import torch

    from inflatox_torch import background
    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_solver import solve_cuda, solve_torch

    batch, n = f0.shape
    d0 = np.zeros_like(f0)
    cuda_kernels.LAUNCHES_BY_KERNEL["B6"] = 0
    t = time.perf_counter()
    rows_np, times_np = background.solve_eom_batch(art, pars, steps, f0, d0, max_err=max_err,
                                                   solver=solver, return_time=True)
    host_s = time.perf_counter() - t
    launches = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    check(launches > 0, f"{label}: the solve launched no kernel")
    check(rows_np.shape == (batch, steps, 2 * n + 1) and times_np.shape == (batch, steps),
          f"{label}: rows {rows_np.shape}, times {times_np.shape}")
    check(bool(np.array_equal(rows_np[:, 0, :n], f0)), f"{label}: row 0 is not the initial state")
    ok = np.isfinite(rows_np).all(axis=(1, 2))
    check(ok.mean() > 0.5, f"{label}: only {ok.mean():.3f} of the trajectories are finite")
    check(bool((np.diff(times_np[ok], axis=1) >= 0).all() and (times_np[ok, -1] > 0).all()),
          f"{label}: times do not increase")
    check(bool((rows_np[ok, -1, 2 * n] < rows_np[ok, 0, 2 * n]).all()),
          f"{label}: H does not decrease")

    device = torch.device("cuda", 0)
    ft = torch.tensor(f0, device=device)
    dt = torch.zeros_like(ft)
    pt = torch.tensor(np.asarray(pars, dtype=np.float64), device=device)
    k_rows, k_times = solve_cuda(art, pt, steps, ft, dt, max_err, solver)
    check(np.array_equal(k_rows.cpu().numpy(), rows_np, equal_nan=True),
          f"{label}: the user-facing call differs from the kernel's own")
    t = time.perf_counter()
    p_rows, p_times, attempts = solve_torch(art, pt, steps, ft, dt, max_err, solver,
                                            count_attempts=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    rel, absolute, same = compare(torch.cat([k_rows, k_times[..., None]], -1),
                                  torch.cat([p_rows, p_times[..., None]], -1), RTOL_SOLVER)
    mean_attempts = attempts.sum().item() / (batch * (steps - 1))
    print(f"{label}: launches={launches} finite trajectories {ok.mean():.4f}; kernel vs "
          f"plain torch on the card: max_rel={rel:.3e} max_abs={absolute:.3e} "
          f"bit_identical={same:.6f}; attempts per row mean {mean_attempts:.4f}, "
          f"most for one trajectory {attempts.max().item()}; host clock: user-facing "
          f"call {host_s:.3f} s, plain version {plain_s:.2f} s")
    m = 64
    cpu = solve_torch(art, pt[:m].cpu() if pt.ndim == 2 else pt.cpu(),
                      steps, ft[:m].cpu(), dt[:m].cpu(), max_err, solver)
    cpu_rows_check(k_rows[:m].cpu(), k_times[:m].cpu(), *cpu, n, label)
    n_bytes = k_rows.numel() * 8 + k_times.numel() * 8 + 2 * ft.numel() * 8 + pt.numel() * 8
    n_ops = attempt_ops(art, solver) * attempts.sum().item()
    return {"launches": launches, "max_abs": absolute, "rows": k_rows, "times": k_times,
            "plain_s": plain_s,
            "args": (pt, steps, ft, dt, max_err, solver), "bound": bound(n_bytes, n_ops),
            "attempts": attempts, "mean_attempts": mean_attempts, "n_ops": n_ops,
            "n_bytes": n_bytes, "cpu": cpu}


def reduce_and_check(art, rows, times, pars, label):
    """Kernel B9 on B6's ``rows`` and ``times`` (views of one B6 output on
    the card), counted, then its five summaries against the plain
    reduction on the host's CPU from the same rows, bit for bit with NaN in
    the same places; then B9 and the plain reduction on the card timed in
    turns, B9's device time from the profiler, and its bound (it reads
    every row and time once).  Returns a dict for the kernel table."""
    import numpy as np
    import torch

    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_survey import survey_reduce_cuda, survey_reduce_torch

    cuda_kernels.LAUNCHES_BY_KERNEL["B9"] = 0
    got = survey_reduce_cuda(art, rows, times, pars)
    torch.cuda.synchronize()
    launches = cuda_kernels.LAUNCHES_BY_KERNEL["B9"]
    check(launches == 1, f"{label}: {launches} B9 launches, expected 1")
    t = time.perf_counter()
    want = survey_reduce_torch(art, rows.cpu(), times.cpu(), pars.cpu())
    cpu_s = time.perf_counter() - t
    max_abs = 0.0
    for name, g, w in zip(("N_inflation", "ended", "H_end", "x_end", "N_span"), got, want):
        g, w = g.cpu().numpy(), w.numpy()
        check(g.shape == w.shape and g.dtype == w.dtype, f"{label}: {name} shape or dtype")
        if g.dtype == bool:
            check(np.array_equal(g, w), f"{label}: {name} differs")
            continue
        nan = np.isnan(w)
        check(np.array_equal(np.isnan(g), nan), f"{label}: {name} NaN masks differ")
        check(np.array_equal(g[~nan].view(np.int64), w[~nan].view(np.int64)),
              f"{label}: {name} not bit for bit the host's plain reduction")
        if (~nan).any():
            max_abs = max(max_abs, float(np.abs(g[~nan] - w[~nan]).max()))
    ended = want[1].double().mean().item()
    check(ended > 0.5, f"{label}: only {ended:.4f} of the trajectories ended")

    def kernel():
        survey_reduce_cuda(art, rows, times, pars)

    def plain():
        survey_reduce_torch(art, rows, times, pars)

    ms, plain_ms, windows = in_turns(kernel, plain, N_TIMED_KERNEL, N_TIMED)
    traced = profiled_ms(kernel, "survey_reduce_kernel", N_TIMED)
    batch, steps, ny = rows.shape
    n_bytes = batch * steps * (ny + 1) * 8
    b9_bound = bound(n_bytes, 0)
    print(f"{label}: five summaries bit for bit the plain reduction on the host's CPU "
          f"({cpu_s:.2f} s there), ended {ended:.4f}; on the card kernel {ms:.4f} ms "
          f"(torch.profiler {traced}), plain torch {plain_ms:.4f} ms (windows "
          + ", ".join(f"{w:.4f}" for w in windows) + f"; {N_TIMED_KERNEL} and {N_TIMED} "
          "chained calls); "
          f"bound {b9_bound[0]:.4f} ms ({b9_bound[1]}; {n_bytes} bytes read)")
    return {"launches": launches, "max_abs": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound": b9_bound}


def cpu_rows_check(kc, kt, cpu_rows, cpu_times, n, label):
    """B6's first trajectories (rows ``kc``, times ``kt``, on the host)
    against the plain version's on the CPU: the times within
    RTOL_CPU_TIMES, the state within RTOL_CPU_PHYSICAL of each component's
    largest value while H > 0 and RTOL_CPU_ALL in all rows, NaN masks
    identical."""
    import torch

    m = kc.shape[0]
    rel_t, _, _ = compare(kt, cpu_times, RTOL_CPU_TIMES)
    check(torch.equal(torch.isnan(kc), torch.isnan(cpu_rows)), f"{label}: CPU NaN masks differ")
    physical = (kc[..., 2 * n] > 0) & (cpu_rows[..., 2 * n] > 0)
    diff = (kc - cpu_rows).abs().nan_to_num()
    scale = cpu_rows.abs().nan_to_num().amax(dim=1, keepdim=True).clamp_min(1e-300)
    scaled = diff / scale  # against each component's largest value on its trajectory
    rel_p = scaled[physical].max().item() if physical.any() else 0.0
    rel_c = scaled.max().item()
    check(rel_p <= RTOL_CPU_PHYSICAL and rel_c <= RTOL_CPU_ALL,
          f"{label}: kernel vs CPU state {rel_p:.3e} while H > 0, {rel_c:.3e} in all rows")
    print(f"{label}: kernel trajectories 0-{m - 1} vs plain torch on the CPU: times "
          f"max_rel={rel_t:.3e}; state, relative to each component's largest value, while "
          f"H > 0 ({physical.double().mean().item():.4f} of the rows) {rel_p:.3e}, in all "
          f"rows {rel_c:.3e}; bit_identical={(kc == cpu_rows).double().mean().item():.6f}")


def cpu_band(art, kind, args, extent, shape, rows, precision="f64"):
    """The plain version on the CPU for grid rows 0 .. rows-1."""
    from inflatox_torch.ops.cuda_kernels import evaluate_points
    from inflatox_torch.ops.dd import DD
    from inflatox_torch.ops.grid import axis_coords

    n1 = shape[1]
    a0 = axis_coords(extent[0], extent[1], shape[0], "cpu", precision)
    a1 = axis_coords(extent[2], extent[3], n1, "cpu", precision)
    if precision == "dd":
        xs = (DD(a0.hi[:rows, None].expand(rows, n1), a0.lo[:rows, None].expand(rows, n1)),
              DD(a1.hi[None].expand(rows, n1), a1.lo[None].expand(rows, n1)))
    else:
        xs = (a0[:rows, None].expand(rows, n1), a1[None].expand(rows, n1))
    return evaluate_points(art, kind, args, xs, precision)


def grid_check(art, kind, args, extent, shape, precision, got, label, rtol=RTOL, rows=64,
               cpu_rtol=None):
    """A grid kernel's output against its plain version on the card and, for
    rows 0 .. rows-1, on the CPU (at ``cpu_rtol``, default ``rtol``; masks
    always identical); returns (max abs error on the card, the plain
    version's output)."""
    import torch

    from inflatox_torch.ops.cuda_kernels import scan_torch

    plain = scan_torch(art, kind, args, extent, shape, got.device, precision)
    rel, absolute, same = compare(got, plain, rtol)
    print(f"{label}: kernel vs plain torch on the card: max_rel={rel:.3e} "
          f"max_abs={absolute:.3e} bit_identical={same:.6f}")
    cpu_rel, _, cpu_same = compare(got[:, :rows].cpu(),
                                   cpu_band(art, kind, args, extent, shape, rows, precision),
                                   rtol if cpu_rtol is None else cpu_rtol)
    print(f"{label}: rows 0-{rows - 1} vs plain torch on the CPU: max_rel={cpu_rel:.3e} "
          f"bit_identical={cpu_same:.6f}")
    torch.cuda.synchronize()
    return absolute, plain


def launched(kernel, label):
    """The launches of ``kernel`` since the counts were set to 0; fails when
    there were none."""
    from inflatox_torch.ops import cuda_kernels

    count = cuda_kernels.LAUNCHES_BY_KERNEL[kernel]
    check(count > 0, f"{label}: kernel {kernel} was launched no time")
    return count


def reset_counts():
    from inflatox_torch.ops import cuda_kernels

    for key in cuda_kernels.LAUNCHES_BY_KERNEL:
        cuda_kernels.LAUNCHES_BY_KERNEL[key] = 0


def mp_model(art, args):
    """V, V_vv, V_wv, V_ww and |∇V|² of the model at 40 digits (sympy's
    expressions through mpmath), as a function of two mpf coordinates."""
    import sympy

    m = art.model
    exprs = [m.potential, m.hesse_cmp[0][0], m.hesse_cmp[1][0], m.hesse_cmp[1][1],
             m.gradient_square]
    symbols = sorted(set().union(*(e.free_symbols for e in exprs)), key=str)
    fn = sympy.lambdify(symbols, exprs, modules="mpmath", cse=True)

    def run(x0, x1):
        import mpmath

        values = []
        for sym in symbols:
            slot = art.symbol_dictionary[str(sym)]
            values.append(mpmath.mpf(float(args[int(slot[5:-1])])) if slot.startswith("args[")
                          else (x0, x1)[int(slot[2:-1])])
        return fn(*values)

    return run


def direct_grid(art, kind, args_batch, extent, shape, device, precision="f64"):
    """A launch of the grid-scan kernel through its library's C entry, the
    parameters on the card and the output allocated once, for timing: the
    wrapper's host work (about 0.1 ms a call) would otherwise set the pace
    of chained launches of the cheap kinds.  Its output is held bit for bit
    against ``scan_batch_cuda``'s first."""
    import numpy as np
    import torch
    from inflatox_torch.ops.cuda_kernels import KINDS, _library, scan_batch_cuda

    args_batch = np.atleast_2d(np.asarray(args_batch, dtype=np.float64))
    lib = _library(art, precision)
    kind_id, n_out = KINDS[kind]
    dtype = torch.float32 if precision == "f32" else torch.float64
    p = torch.tensor(args_batch, dtype=dtype, device=device)
    out = torch.empty((len(args_batch), n_out, *shape), dtype=dtype, device=device)
    x0a, x0b, x1a, x1b = extent
    geometry = (x0a, (x0b - x0a) / shape[0], x1a, (x1b - x1a) / shape[1], *shape)

    def launch():
        err = lib.inflx_grid_scan_batch(kind_id, p.data_ptr(), out.data_ptr(), *geometry,
                                        len(args_batch), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"direct launch of the {kind} grid scan failed: CUDA error {err}")

    launch()
    want = scan_batch_cuda(art, kind, args_batch, extent, shape, device, precision)
    check(bool(((out == want) | (out.isnan() & want.isnan())).all()),
          f"the direct {kind} launch differs from scan_batch_cuda's")
    return launch


def adaptive_turns(kernel, plain):
    """in_turns with window lengths set from one call of each (about 0.2 s of
    kernel work, at most 20 plain calls a window)."""
    one_kernel = time_ms(kernel, 1, 1)
    one_plain = time_ms(plain, 1, 1)
    n_kernel = max(3, min(N_TIMED_KERNEL, int(200 / max(one_kernel, 1e-3))))
    n_plain = max(1, min(N_TIMED, int(1000 / max(one_plain, 1e-3))))
    return in_turns(kernel, plain, n_kernel, n_plain, 0) + (n_kernel, n_plain)


def points_and_check(al, art, args, pts, label, cpu_rtol=RTOL):
    """The four on-trajectory scans through ``GeneralisedAL``, counted,
    then kernel vs plain version on the card and, for the first 4096
    points, on the CPU (at ``cpu_rtol``; masks always identical).  Returns
    (launches, max abs error)."""
    import numpy as np

    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_kernels import scan_points_cuda, scan_points_torch

    reset_counts()
    ot = al.complete_analysis_ot(args, pts, progress=False)
    singles = {kind: getattr(al, kind + "_ot")(args, pts, progress=False)
               for kind in ("consistency", "consistency_rapidturn", "epsilon_v")}
    launches = cuda_kernels.launches()
    check(launches > 0, f"{label}: the on-trajectory scans launched no kernel")
    n = pts.shape[0]
    check(len(ot) == 6 and all(o.shape == (n, 1) for o in ot), f"{label}: output shapes")
    check(all(s.shape == (n,) for s in singles.values()), f"{label}: single-kind shapes")
    check(np.nanmax(ot[0]) <= 1.0 and np.isfinite(ot[1]).mean() > 0.5,
          f"{label}: consistency above 1 or too few finite ε_V")
    worst = 0.0
    for kind, user in [("complete_analysis", np.concatenate(ot, axis=1).T), *singles.items()]:
        got = scan_points_cuda(art, kind, args, pts)
        check(np.array_equal(got.cpu().numpy().reshape(user.shape), user, equal_nan=True),
              f"{label} {kind}: the user-facing call differs from the kernel's own")
        rel, absolute, same = compare(got, scan_points_torch(art, kind, args, pts))
        worst = max(worst, absolute)
        cpu_rel, _, cpu_same = compare(got[:, :4096].cpu(),
                                       scan_points_torch(art, kind, args, pts[:4096].cpu()),
                                       cpu_rtol)
        print(f"{label} {kind}: kernel vs plain torch on the card: max_rel={rel:.3e} "
              f"max_abs={absolute:.3e} bit_identical={same:.6f}; first 4096 points vs "
              f"the CPU: max_rel={cpu_rel:.3e} bit_identical={cpu_same:.6f}")
    return launches, worst


# ------------------------------------------------------------------------- #
# parameter sweeps                                                          #
# ------------------------------------------------------------------------- #


def consistency_nanmin(maps):
    """bench cfg5's reduction: the least consistency of one set, NaN
    skipped."""
    import torch

    c = maps[0]
    return torch.where(torch.isnan(c), torch.inf, c).min()


def min_and_argmin(maps):
    """bench cfg5c's reduction (scripts/sweep_rehearsal.py:46-50) in torch:
    the least consistency of one set and its flat index, NaN skipped."""
    import torch

    c = torch.where(torch.isnan(maps[0]), torch.inf, maps[0])
    return torch.stack([c.min(), c.argmin().to(c.dtype)])


def rehearsal_batch(configs):
    import numpy as np

    return np.linspace(0.5, 2.0, configs)[:, None]


def sweep_worker(argv):
    """``--sweep-worker DIR CONFIGS N BUNDLE DEVICE``: the checkpointed
    rehearsal sweep at N² on DEVICE, the model loaded from the bundle the
    parent saved."""
    sys.path.insert(0, HERE)
    import inflatox_torch
    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.parallel import parameter_sweep

    ckdir, configs, n, bundle, device = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    al = GeneralisedAL(inflatox_torch.CompiledModel.load(bundle), device=device,
                       validate_basis=False)
    parameter_sweep(al, rehearsal_batch(configs), DOC_EXTENT, (n, n),
                    chunk_size=REHEARSAL_CHUNK, checkpoint_dir=ckdir, progress=False,
                    reduce_fn=min_and_argmin)
    return 0


def trace_worker(argv):
    """``--trace-worker DIR``: one hyperinflation ``complete_analysis`` at
    4096² on kernel B1 inside ``utils.profiling.trace(DIR)`` (phase 28);
    prints ``{"B1": launches}`` as its last line.  ``--trace-worker DIR
    posterior``: phase 30's profile (:func:`posterior_trace_worker`)."""
    sys.path.insert(0, HERE)
    if argv[1:2] == ["posterior"]:
        return posterior_trace_worker(argv[0])
    import torch

    import inflatox_torch
    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.utils import profiling

    model, args = inflatox_torch.models.hyperinflation()
    al = GeneralisedAL(inflatox_torch.Compiler(model, silent=True).compile(),
                       device=torch.device("cuda", 0), validation_seed=7)
    al.complete_analysis(args, *DOC_EXTENT, 64, 64, progress=False, output="f64_device")
    torch.cuda.synchronize()
    reset_counts()
    with profiling.trace(argv[0], label="phase28"):
        with profiling.annotate("inflatox_complete_analysis"):
            al.complete_analysis(args, *DOC_EXTENT, GEO_N, GEO_N, progress=False,
                                 output="f64_device")
        torch.cuda.synchronize()
    print(json.dumps({"B1": cuda_kernels.LAUNCHES_BY_KERNEL["B1"]}))
    return 0

def chunk_files(ckdir):
    try:
        return sorted(f for f in os.listdir(ckdir) if f.startswith("chunk_") and f.endswith(".npy"))
    except FileNotFoundError:
        return []


def rehearse_kill_resume(art, device, card):
    """Phase 20: size the rehearsal, run it in a worker, SIGKILL the worker
    mid-run, resume in this process, check.  Returns the summary dict."""
    import glob

    import numpy as np
    import torch

    import inflatox_torch
    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.parallel import parameter_sweep

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    os.makedirs(SWEEP_DIR)
    bundle = os.path.join(SWEEP_DIR, "hyperinflation.json")
    art.save(bundle)
    al = GeneralisedAL(inflatox_torch.CompiledModel.load(bundle), device=device,
                       validate_basis=False)
    shape = (SWEEP_N, SWEEP_N)

    def sweep(batch, **kw):
        return parameter_sweep(al, batch, DOC_EXTENT, shape, chunk_size=REHEARSAL_CHUNK,
                               progress=False, reduce_fn=min_and_argmin, **kw)

    # size: the checkpointed rate over 64 chunks, then enough configs for
    # REHEARSAL_WORKER_S seconds of the worker's sweep
    probe = rehearsal_batch(64 * REHEARSAL_CHUNK)
    sweep(probe[:2 * REHEARSAL_CHUNK])
    torch.cuda.synchronize()
    t = time.perf_counter()
    sweep(probe, checkpoint_dir=os.path.join(SWEEP_DIR, "probe"))
    per_config = (time.perf_counter() - t) / len(probe)
    n_chunks = max(64, int(np.ceil(REHEARSAL_WORKER_S / per_config / REHEARSAL_CHUNK)))
    configs = n_chunks * REHEARSAL_CHUNK
    batch = rehearsal_batch(configs)
    t = time.perf_counter()
    reference = sweep(batch)
    reference_s = time.perf_counter() - t
    torch.cuda.empty_cache()

    ckdir = os.path.join(SWEEP_DIR, "checkpoint")
    log_path = os.path.join(SWEEP_DIR, "worker.log")
    kill_at = int(n_chunks * REHEARSAL_KILL_AT)
    with open(log_path, "w") as log:
        t = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sweep-worker",
                                 ckdir, str(configs), str(SWEEP_N), bundle, str(device)],
                                stdout=log, stderr=log)
        try:
            killed_at = None
            while proc.poll() is None and time.perf_counter() - t < 600:
                if len(chunk_files(ckdir)) >= kill_at:
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    killed_at = len(chunk_files(ckdir))
                    break
                time.sleep(0.002)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    worker_s = time.perf_counter() - t
    with open(log_path) as log:
        tail = log.read()[-2000:]
    check(killed_at is not None, f"sweep rehearsal: the worker ended (exit {proc.returncode}) "
          f"before the kill, with {len(chunk_files(ckdir))} of {n_chunks} chunks: {tail}")
    check(0.1 * n_chunks <= killed_at <= 0.9 * n_chunks,
          f"sweep rehearsal: killed with {killed_at} of {n_chunks} chunks, outside 10-90 %")
    temp_left = glob.glob(os.path.join(ckdir, "*.tmp.*"))
    before = {f: os.stat(os.path.join(ckdir, f)) for f in chunk_files(ckdir)}

    t = time.perf_counter()
    resumed = sweep(batch, checkpoint_dir=ckdir)
    resume_s = time.perf_counter() - t
    check(resumed.shape == (configs, 2), f"sweep rehearsal: result shape {resumed.shape}")
    check(np.array_equal(resumed, reference, equal_nan=True),
          "sweep rehearsal: the resumed result differs from the uncheckpointed sweep")
    check(len(chunk_files(ckdir)) == n_chunks, "sweep rehearsal: chunk files missing")
    check(not glob.glob(os.path.join(ckdir, "*.tmp.*")), "sweep rehearsal: a temp file is left")
    rewritten = [f for f, st in before.items()
                 if (os.stat(os.path.join(ckdir, f)).st_ino, os.stat(os.path.join(ckdir, f)).st_mtime_ns)
                 != (st.st_ino, st.st_mtime_ns)]
    check(not rewritten, f"sweep rehearsal: chunks written before the kill were rewritten: "
          f"{rewritten[:3]}")
    try:
        sweep(batch + 1e-3, checkpoint_dir=ckdir)
    except ValueError as e:
        check("refusing to resume" in str(e), f"sweep rehearsal: wrong refusal: {e}")
    else:
        raise SmokeFailure("sweep rehearsal: a resume with different args did not raise")
    resumed_configs = (n_chunks - killed_at) * REHEARSAL_CHUNK
    summary = {"configs": configs, "chunks": n_chunks, "killed_at_chunks": killed_at,
               "temp_files_at_kill": len(temp_left), "worker_s": worker_s,
               "reference_s": reference_s, "resume_s": resume_s,
               "resumed_configs_per_hour": resumed_configs / resume_s * 3600,
               "uncheckpointed_configs_per_hour": configs / reference_s * 3600}
    print(f"sweep rehearsal (cfg5c on the port) on {card}: {configs} configs at {SWEEP_N}², "
          f"chunk {REHEARSAL_CHUNK}, {n_chunks} chunks; worker SIGKILLed after {worker_s:.2f} s "
          f"with {killed_at} chunks written ({len(temp_left)} temp file(s) at the kill); "
          f"resumed {n_chunks - killed_at} chunks in {resume_s:.3f} s "
          f"({summary['resumed_configs_per_hour']:.4e} configs/hour); the uncheckpointed sweep "
          f"{reference_s:.3f} s ({summary['uncheckpointed_configs_per_hour']:.4e} configs/hour); "
          "resumed result equal to it exactly, no temp file left, no chunk rewritten, a "
          "different args refused")
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    return summary


# ------------------------------------------------------------------------- #
# phases 22-27: kernel B8, the special functions                             #
# ------------------------------------------------------------------------- #

DF32_SPECIAL = "inflatox_tpu/lowering/df32_special.py"
#: B8's function → the line of the TPU's double-f32 function it replaces
B8_REPLACES = {"hyp0f1": 105, "besselj": 810, "bessely": 892, "besseli": 945, "besselk": 1061,
               "sph_jn": 1119, "sph_yn": 1186, "erf": 1275, "erfc": 1287, "lgamma": 1350,
               "gamma": 1362, "polygamma": 1440, "hyp1f1": 1563, "hyp2f1": 1605,
               "hyp2f0": 1640}


def _mp_sph(fn):
    import mpmath

    return lambda nu: (lambda z: mpmath.sqrt(mpmath.pi / (2 * z)) * fn(nu + mpmath.mpf(1) / 2, z))


def b8_cases():
    """Phase 22's cases: (label, function, special_eval instance, parameters,
    argument range, 40-digit mpmath reference or None (NaN expected), its
    tolerance, its absolute floor and floor share of the largest value)."""
    import mpmath

    half = mpmath.mpf(1) / 2
    cases = []
    for fn, mp_fn, ints, fracs, rng_int, rng_frac, tol_int, tol_frac, floor in (
            ("besselj", mpmath.besselj, (0, 1, 5, -2),
             (0.3, 2.5, 12.7, 29.9, -12.7, 30.5, -30.5, 35.3), (0.05, 30.0), (0.05, 200.0),
             1e-8, 1e-11, 1e-3),
            ("bessely", mpmath.bessely, (0, 1, 5, -2),
             (0.3, 2.5, 12.7, 29.9, -12.7, 30.5, -30.5, 35.3), (0.2, 40.0), (0.05, 200.0),
             2e-11, 1e-11, 1e-3),
            ("besseli", mpmath.besseli, (0, 1, 5, -2), (0.3, 2.5, 12.7, -12.7), (0.1, 15.0),
             (0.1, 15.0), 1e-7, 1e-9, 0.0),
            ("besselk", mpmath.besselk, (0, 1, 5, -2), (0.3, 2.5, 12.7, -12.7, 30.5, 35.3),
             (0.1, 40.0), (0.1, 40.0), 1e-13, 1e-12, 0.0)):
        for n in ints:
            cases.append((f"{fn} n={n}", fn, f"{fn}_{'m' if n < 0 else ''}{abs(n)}", (),
                          rng_int, (lambda z, n=n, f=mp_fn: f(n, z)), tol_int, 0.0, floor))
        for nu in fracs:
            mp = None if abs(nu) > 30.5 else (lambda z, nu=nu, f=mp_fn: f(mpmath.mpf(nu), z))
            cases.append((f"{fn} ν={nu}", fn, f"{fn}_nu", (nu,), rng_frac, mp, tol_frac, 0.0,
                          floor))
    for fn, mp_fn, tol, floor in (("sph_jn", mpmath.besselj, 5e-13, 1e-9),
                                  ("sph_yn", mpmath.bessely, 1e-10, 1e-9)):
        for n in range(9):
            cases.append((f"{fn} n={n}", fn, f"{fn}_{n}", (), (0.2, 30.0),
                          (lambda z, n=n, f=mp_fn: mpmath.sqrt(mpmath.pi / (2 * z))
                           * f(n + half, z)), tol, 0.0, floor))
        # ν = 2.5 takes the integer-order J_3/Y_3 (J's Miller recurrence: 1e-8)
        for nu, inst, tol_nu in ((2.3, f"{fn}_nu", 1e-11),
                                 (2.5, f"{fn}_half3", 1e-8 if fn == "sph_jn" else 1e-11)):
            cases.append((f"{fn} ν={nu}", fn, inst, (nu,) if inst.endswith("nu") else (),
                          (0.5, 40.0), (lambda z, nu=nu, f=mp_fn: mpmath.sqrt(
                              mpmath.pi / (2 * z)) * f(mpmath.mpf(nu) + half, z)),
                          tol_nu, 0.0, 1e-3))
    for b in (0.5, 2.5, 7.0):
        cases.append((f"hyp0f1 b={b}", "hyp0f1", "hyp0f1", (b,), (-20.0, 20.0),
                      (lambda z, b=b: mpmath.hyp0f1(b, z)), 1e-10, 0.0, 0.0))
    for a, b in ((0.5, 1.5), (1.5, 2.5), (-1.5, 2.5), (3.5, 0.75)):
        cases.append((f"hyp1f1 a={a} b={b}", "hyp1f1", "hyp1f1", (a, b), (-20.0, 20.0),
                      (lambda z, a=a, b=b: mpmath.hyp1f1(a, b, z)), 5e-11, 1e-300, 0.0))
    for a, b, c in ((0.5, 1.5, 2.5), (0.25, 0.75, 1.25), (1.0, 2.0, 3.5), (2.5, 0.5, 3.0)):
        cases.append((f"hyp2f1 {a},{b};{c}", "hyp2f1", "hyp2f1", (a, b, c), (-0.95, 0.95),
                      (lambda z, a=a, b=b, c=c: mpmath.hyp2f1(a, b, c, z)), 5e-11, 0.0, 0.0))
    for a, b in ((0.5, 1.0), (1.5, 2.0)):
        cases.append((f"hyp2f0 {a},{b}", "hyp2f0", "hyp2f0", (a, b), (-0.02, 0.02),
                      (lambda z, a=a, b=b: mpmath.re(mpmath.hyp2f0(a, b, z))), 1e-12, 0.0, 0.0))
    cases += [
        ("erf", "erf", "erf", (), (-6.0, 6.0), mpmath.erf, 2e-13, 0.0, 1e-12),
        ("erfc", "erfc", "erfc", (), (-6.0, 7.5), mpmath.erfc, 1e-12, 0.0, 0.0),
        ("lgamma", "lgamma", "lgamma", (), (-7.95, 33.0),
         lambda z: mpmath.log(abs(mpmath.gamma(z))), 1e-11, 1e-2, 0.0),
        ("gamma", "gamma", "gamma", (), (-7.95, 33.0), mpmath.gamma, 2e-12, 0.0, 0.0),
    ]
    for n in range(4):
        cases.append((f"polygamma n={n}", "polygamma", f"polygamma_{n}", (), (-7.95, 30.0),
                      (lambda z, n=n: mpmath.polygamma(n, z)), 1e-12, 1e-2, 0.0))
    return cases


def torch_library():
    """The one torch call that computes a phase-22 instance, where there is
    one (a yardstick of speed, used nowhere in the port)."""
    import torch

    ts = torch.special
    return {"besselj_0": ts.bessel_j0, "besselj_1": ts.bessel_j1, "bessely_0": ts.bessel_y0,
            "bessely_1": ts.bessel_y1, "besseli_0": ts.modified_bessel_i0,
            "besseli_1": ts.modified_bessel_i1, "besselk_0": ts.modified_bessel_k0,
            "besselk_1": ts.modified_bessel_k1, "sph_jn_0": ts.spherical_bessel_j0,
            "erf": ts.erf, "erfc": ts.erfc, "lgamma": torch.lgamma, "polygamma_0": ts.digamma,
            "polygamma_1": lambda z: ts.polygamma(1, z)}


def floored_error(got, want, frac, floor):
    """max |got − want| / max(|want|, floor, frac · max|want|) over the
    finite values of ``want``, in f64."""
    import torch

    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    if not fin.any():
        return 0.0
    scale = want[fin].abs().clamp_min(max(floor, frac * want[fin].abs().max().item()))
    return ((got[fin] - want[fin]).abs() / scale).max().item()


def b8_alone(device, card):
    """Phase 22: kernel B8 alone over SF_N arguments per case, f64 and f32,
    against its plain version on the card (the first SF_PLAIN_N, which
    begin with every route's branch points, their neighbours, NaN, ±0 and
    ±inf), against 40-digit mpmath at SF_MP_POINTS points, timed on the
    arguments in random order and sorted (a warp whose lanes take different
    routes pays for each; sorted, neighbouring lanes share theirs) beside
    the torch call that computes the same function where there is one.
    Returns the slowest f64 case's numbers for the kernel table."""
    import mpmath
    import numpy as np
    import torch

    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.special_eval import special_eval_cuda, special_eval_torch

    cuda_kernels.LAUNCHES_BY_KERNEL["B8"] = 0
    library = torch_library()
    gen = torch.Generator(device=device).manual_seed(22)
    edges = torch.tensor(SF_EDGES, dtype=torch.float64, device=device)
    odd = torch.tensor([float("nan"), 0.0, -0.0, float("inf"), -float("inf")],
                       dtype=torch.float64, device=device)
    edges = torch.cat([edges, torch.nextafter(edges, edges - 1.0),
                       torch.nextafter(edges, edges + 1.0), odd])
    slowest, worst_bits, summary = None, 1.0, []
    for label, fn, inst, params, (lo, hi), mp_ref, tol, abs_floor, frac in b8_cases():
        z64 = torch.empty(SF_N, dtype=torch.float64, device=device).uniform_(lo, hi,
                                                                             generator=gen)
        z64[:len(edges)] = edges
        k64 = special_eval_cuda(inst, z64, params)
        t = time.perf_counter()
        p64 = special_eval_torch(inst, z64[:SF_PLAIN_N], params)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        rel, _, same = compare(k64[:SF_PLAIN_N], p64)
        z32 = z64.float()
        k32 = special_eval_cuda(inst, z32, params)
        p32 = special_eval_torch(inst, z32[:SF_PLAIN_N], params)
        for mask in (torch.isnan, torch.isposinf, torch.isneginf):
            check(torch.equal(mask(k32[:SF_PLAIN_N]), mask(p32)),
                  f"B8 {label} f32: {mask.__name__} masks differ")
        err32 = floored_error(k32[:SF_PLAIN_N], p32, 1e-3, 0.0)
        check(err32 <= RTOL_F32, f"B8 {label} f32: {err32:.3e} from the plain version")
        same32 = ((k32[:SF_PLAIN_N] == p32) | (k32[:SF_PLAIN_N].isnan() & p32.isnan())
                  ).double().mean().item()
        worst_bits = min(worst_bits, same, same32)
        z_sorted = z64.sort().values
        ms = time_ms(lambda: special_eval_cuda(inst, z64, params), 10, 1)
        ms_sorted = time_ms(lambda: special_eval_cuda(inst, z_sorted, params), 10, 1)
        # 40-digit mpmath at points of the range (Γ's and ψ's away from their poles)
        zs = np.linspace(lo, hi, 4 * SF_MP_POINTS + 1)[1:-1]
        if fn in ("lgamma", "gamma", "polygamma"):
            zs = zs[np.abs(zs - np.round(zs)) > 0.04]
        zs = zs[:: max(1, len(zs) // SF_MP_POINTS)][:SF_MP_POINTS]
        zt = torch.tensor(zs, dtype=torch.float64, device=device)
        got = special_eval_cuda(inst, zt, params).cpu()
        if mp_ref is None:
            check(bool(torch.isnan(got).all()), f"B8 {label}: not NaN beyond |ν| = 30.5")
            mp_err = "NaN as expected"
        else:
            with mpmath.workdps(40):
                want = torch.tensor([float(mp_ref(mpmath.mpf(float(v)))) for v in zs],
                                    dtype=torch.float64)
            check(torch.equal(torch.isnan(got), torch.isnan(want)), f"B8 {label}: NaN vs mpmath")
            err = floored_error(got, want, frac, abs_floor)
            check(err <= tol, f"B8 {label}: {err:.3e} from 40-digit mpmath (tolerance {tol})")
            mp_err = f"{err:.3e} (tolerance {tol})"
        lib_ms = lib_sorted = None
        if inst in library and not params:
            lib_ms = time_ms(lambda: library[inst](z64), 10, 1)
            lib_sorted = time_ms(lambda: library[inst](z_sorted), 10, 1)
        # the operations each argument's route needs, on SF_COUNT_N evenly spaced arguments
        ops = special_ops([lambda z: special_eval_torch(inst, z, params)],
                          z64[::SF_N // SF_COUNT_N]).double().mean().item()
        line = (f"B8 {label}: kernel {ms:.4f} ms at {SF_N} f64 arguments in random order, "
                f"{ms_sorted:.4f} ms sorted; plain torch "
                f"{plain_s * 1e3:.1f} ms at the first {SF_PLAIN_N} (one call); f64 vs plain "
                f"max_rel={rel:.3e} bit_identical={same:.6f}; f32 vs plain {err32:.3e} "
                f"bit_identical={same32:.6f}; {len(zs)} points vs 40-digit mpmath {mp_err}; "
                f"{ops:.2f} operations an argument (mean over {SF_COUNT_N})"
                + (f"; torch.special's {lib_ms:.4f} ms, sorted {lib_sorted:.4f}"
                   if lib_ms is not None else ""))
        print(line)
        summary.append({"case": label, "ms": ms, "ms_sorted": ms_sorted, "library_ms": lib_ms,
                        "library_ms_sorted": lib_sorted, "ops": ops,
                        "bound_ms": bound(SF_N * 16, ops * SF_N)[0],
                        "bit_identical": min(same, same32)})
        if slowest is None or ms > slowest["ms"]:
            slowest = {"label": label, "fn": fn, "inst": inst, "params": params, "ms": ms,
                       "ops": ops, "lo": lo, "hi": hi, "library_ms": lib_ms,
                       "max_abs": (k64[:SF_PLAIN_N] - p64).abs().nan_to_num().max().item()}
        del z64, k64, p64, z32, k32, p32
    # the slowest case's plain version over all SF_N arguments, for the table
    z = torch.empty(SF_N, dtype=torch.float64, device=device).uniform_(
        slowest["lo"], slowest["hi"], generator=gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    special_eval_torch(slowest["inst"], z, slowest["params"])
    torch.cuda.synchronize()
    slowest["plain_ms"] = (time.perf_counter() - t) * 1e3
    slowest["bound"] = bound(SF_N * 16, slowest["ops"] * SF_N)
    slowest["launches"] = cuda_kernels.LAUNCHES_BY_KERNEL["B8"]
    print("B8 cases: " + json.dumps(summary))
    print(f"B8 alone on {card}: every case's kernel bit-identical share at least "
          f"{worst_bits:.6f} (f64 and f32); the slowest, {slowest['label']}, "
          f"{slowest['ms']:.4f} ms at {SF_N} arguments, plain torch {slowest['plain_ms']:.1f} ms "
          f"(one call), bound {slowest['bound'][0]:.4f} ms ({slowest['bound'][1]}; "
          f"{slowest['ops']:.2f} operations an argument, the mean of its route's over "
          f"{SF_COUNT_N} of them)")
    return slowest


def special_models():
    """Phase 23's models: S1 (bench cfg4b's 1F1 + 2F1 + erf·Γ potential,
    bench.py:338-340), S2 (tests/test_df32_special.py:75) and S3 (:249), and
    C9's Piecewise and sinc models (phase 27)."""
    import sympy

    import inflatox_torch

    x, y, a = sympy.symbols("x y a")
    half, th, fh = sympy.Rational(1, 2), sympy.Rational(3, 2), sympy.Rational(5, 2)
    potentials = {
        "S1": (a * sympy.hyper((half,), (th,), -(x**2)) + sympy.hyper((half, th), (fh,), y**2 / 4)
               / 10 + sympy.erf(x) * sympy.gamma(y + 2) / 50 + 2),
        "S2": a * sympy.besselj(0, x) ** 2 + sympy.besselk(1, x + 2) * y**2 + 2,
        "S3": (a * sympy.besselj(sympy.Rational(3, 10), x) ** 2
               + sympy.besselk(sympy.Rational(5, 2), x + 2) * y**2 + 2),
        "C9": sympy.Piecewise((a * x**2, x > 0), (a * x**4, True)) + y**2,
        "sinc": a * sympy.sinc(x) + y**2,
    }
    out = {}
    for name, V in potentials.items():
        model = inflatox_torch.InflationModelBuilder.new(
            [x, y], [[1, 0], [0, 1]], V, name, silent=True, simplify=False,
            assertions=False).build()
        out[name] = inflatox_torch.Compiler(model, silent=True).compile()
    return out


def f32_check(art, kind, args, extent, shape, got, label):
    """An f32 grid kernel's output against its plain f32 version on the card:
    identical masks; every value within rtol 1e-5 where the f32 and f64 plain
    versions agree within 1e-4 (as phase 13), the share within it reported.
    Returns (max abs error, share within)."""
    import torch

    from inflatox_torch.ops.cuda_kernels import scan_torch

    plain32 = scan_torch(art, kind, args, extent, shape, got.device, "f32")
    plain64 = scan_torch(art, kind, args, extent, shape, got.device)
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(mask(got), mask(plain32)), f"{label}: {mask.__name__} masks differ")
    diff = (got.double() - plain32.double()).abs()
    within = ((diff <= RTOL_F32 * plain32.double().abs()) | (got == plain32)
              | (torch.isnan(got) & torch.isnan(plain32)))
    settled = torch.isfinite(plain64) & ((plain32.double() - plain64).abs()
                                          <= 1e-4 * plain64.abs())
    check(bool(within[settled].all()), f"{label}: a settled point beyond rtol {RTOL_F32}")
    same = ((got == plain32) | (torch.isnan(got) & torch.isnan(plain32))).double().mean().item()
    share = within.double().mean().item()
    print(f"{label}: kernel vs plain f32 torch on the card: share within rtol {RTOL_F32} "
          f"{share:.6f}, bit_identical={same:.6f}; where the f32 and f64 plain versions agree "
          f"within 1e-4 ({settled.double().mean().item():.6f} of the points) all within")
    return diff.nan_to_num(posinf=0.0).max().item(), share


def mp_grid_check(art, args, extent, n, device, label):
    """V, V_vv, V_wv, V_ww and |∇V|² from kernel B1 at SF_MP_POINTS grid
    points against 40-digit mpmath at the same f64 coordinates (relative,
    floored at 1e-9 of |V|); returns the worst error."""
    import mpmath
    import numpy as np

    from inflatox_torch.ops.cuda_kernels import scan_cuda

    v = scan_cuda(art, "potential", args, extent, (n, n), device)[0]
    h = scan_cuda(art, "hesse", args, extent, (n, n), device)
    eps = scan_cuda(art, "epsilon_v", args, extent, (n, n), device)[0]
    reference = mp_model(art, args)
    rng = np.random.default_rng(23)
    x0a, x0b, x1a, x1b = extent
    dx0, dx1 = (x0b - x0a) / n, (x1b - x1a) / n
    worst = [0.0] * 5
    with mpmath.workdps(40):
        for i, j in zip(rng.integers(0, n, SF_MP_POINTS), rng.integers(0, n, SF_MP_POINTS)):
            i, j = int(i), int(j)
            exact = reference(mpmath.mpf(x0a + i * dx0), mpmath.mpf(x1a + j * dx1))
            vv = v[i, j].item()
            got = [vv, h[0, i, j].item(), h[2, i, j].item(), h[3, i, j].item(),
                   2.0 * eps[i, j].item() * vv * vv]
            floor = 1e-9 * abs(float(exact[0]))
            for k in range(5):
                worst[k] = max(worst[k], abs(float((got[k] - exact[k])
                                                   / max(abs(exact[k]), floor))))
    names = ("V", "V_vv", "V_wv", "V_ww", "|∇V|²")
    print(f"{label}: kernel B1 at {SF_MP_POINTS} grid points vs 40-digit mpmath, largest "
          "relative error: " + ", ".join(f"{nm} {w:.3e}" for nm, w in zip(names, worst)))
    check(max(worst) <= 1e-11, f"{label}: a model function beyond 1e-11 of mpmath")
    return max(worst)


def special_solve_check(art, pars, f0, steps, label, device, parts):
    """Phase 25: S2's solves on kernel B6 (B8 in its derivative) through
    ``solve_eom_batch``, counted; the first SPECIAL_SOLVE_ROWS rows against
    the plain version on the card (rtol 1e-12, identical NaN masks) and, for
    trajectories 0-63, on the CPU (phase 8's tolerances).  The plain version
    runs some 6,000 torch operations a derivative here, so only the prefix
    is compared.  The whole launch's attempts come from ``parts``,
    scripts/probe_solver_chain.py's instrumented copy of B6 for S2, which
    makes the plain version's attempts on the prefix (checked).  Returns
    what the kernel table needs."""
    import numpy as np
    import probe_solver_chain as chain
    import torch

    from inflatox_torch import background
    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_solver import solve_cuda, solve_torch

    batch, n = f0.shape
    d0 = np.zeros_like(f0)
    cuda_kernels.LAUNCHES_BY_KERNEL["B6"] = 0
    t = time.perf_counter()
    rows_np, times_np = background.solve_eom_batch(art, pars, steps, f0, d0, solver="rkf",
                                                   return_time=True, device=device)
    host_s = time.perf_counter() - t
    launches = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    check(launches > 0, f"{label}: the solve launched no kernel")
    ok = np.isfinite(rows_np).all(axis=(1, 2))
    check(rows_np.shape == (batch, steps, 2 * n + 1) and ok.mean() > 0.5,
          f"{label}: rows {rows_np.shape}, finite share {ok.mean():.3f}")
    check(bool((np.diff(times_np[ok], axis=1) >= 0).all()), f"{label}: times do not increase")
    ft = torch.tensor(f0, dtype=torch.float64, device=device)
    dt = torch.zeros_like(ft)
    pt = torch.tensor(np.asarray(pars, dtype=np.float64), device=device)
    m = SPECIAL_SOLVE_ROWS
    k_rows, k_times = solve_cuda(art, pt, m, ft, dt)
    check(np.array_equal(k_rows.cpu().numpy(), rows_np[:, :m], equal_nan=True),
          f"{label}: the first {m} rows of the full solve differ from a {m}-row solve")
    t = time.perf_counter()
    p_rows, p_times, attempts = solve_torch(art, pt, m, ft, dt, count_attempts=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    rel, absolute, same = compare(torch.cat([k_rows, k_times[..., None]], -1),
                                  torch.cat([p_rows, p_times[..., None]], -1), RTOL_SOLVER)
    cpu_rows, cpu_times = solve_torch(art, pt.cpu(), m, ft[:64].cpu(), dt[:64].cpu())
    kc, kt = k_rows[:64].cpu(), k_times[:64].cpu()
    rel_t, _, _ = compare(kt, cpu_times, RTOL_CPU_TIMES)
    check(torch.equal(torch.isnan(kc), torch.isnan(cpu_rows)), f"{label}: CPU NaN masks differ")
    scale = cpu_rows.abs().nan_to_num().amax(dim=1, keepdim=True).clamp_min(1e-300)
    rel_c = ((kc - cpu_rows).abs().nan_to_num() / scale).max().item()
    check(rel_c <= RTOL_CPU_PHYSICAL, f"{label}: kernel vs CPU state {rel_c:.3e}")
    prefix_ms = time_ms(lambda: solve_cuda(art, pt, m, ft, dt), 5, 1)
    ms = time_ms(lambda: solve_cuda(art, pt, steps, ft, dt), 3, 1)
    # the attempts of the whole launch, and B8's operations per derivative
    # on a sample of the states the solve recorded
    prefix_attempts = chain.attribute(parts, 0, ft, dt, pt, m)["attempts_total"]
    check(prefix_attempts == attempts.sum().item(),
          f"{label}: the instrumented copy made {prefix_attempts} attempts on the first {m} "
          f"rows, the plain version {attempts.sum().item()}")
    n_attempts = chain.attribute(parts, 0, ft, dt, pt, steps)["attempts_total"]
    states = rows_np[ok].reshape(-1, 2 * n + 1)
    states = torch.tensor(states[:: max(1, len(states) // SF_COUNT_N)][:SF_COUNT_N],
                          device=device)
    per_deriv = special_ops([art.eom, art.eom_hdot], list(states[:, :n].T),
                            list(states[:, n:2 * n].T), pt).double().mean().item()
    per_attempt = attempt_ops(art, "rkf", per_deriv)
    print(f"{label}: launches={launches}, finite trajectories {ok.mean():.4f}, user-facing call "
          f"{host_s:.3f} s host clock; kernel {ms:.4f} ms for {steps} rows, {n_attempts} "
          f"attempts; the first {m} rows (of {steps}) vs plain torch on the card: "
          f"max_rel={rel:.3e} max_abs={absolute:.3e} bit_identical={same:.6f} (plain version "
          f"{plain_s:.2f} s, kernel {prefix_ms:.4f} ms for them, {prefix_attempts} attempts, "
          f"as the plain version's); trajectories 0-63 vs the CPU: times max_rel={rel_t:.3e}, "
          f"state {rel_c:.3e}; B8 {per_deriv:.2f} operations a derivative (mean over "
          f"{len(states)} of the solve's states), {per_attempt:.2f} an attempt")
    n_bytes = steps * (2 * n + 2) * batch * 8 + 2 * ft.numel() * 8 + pt.numel() * 8
    return {"launches": launches, "max_abs": absolute, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound": bound(n_bytes, per_attempt * n_attempts)}


def special_phases(special, device, card, row, timed_row, grid_src, pk, s2_parts):
    """Phases 22-27 (kernel B8).  Rows made by ``timed_row`` join its table;
    the others are returned.  ``s2_parts`` is S2's instrumented solver
    library (scripts/probe_solver_chain.py), which counts B6's attempts."""
    import numpy as np
    import torch

    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.ops.build import load_grid_scan
    from inflatox_torch.ops.cuda_kernels import (
        scan_batch_cuda,
        scan_batch_torch,
        scan_cuda,
        scan_points_cuda,
        scan_points_torch,
        scan_torch,
    )
    from inflatox_torch.parallel import parameter_sweep

    rows, b8_total, point_bounds = [], 0, {}
    sf_src = "inflatox_torch/csrc/special.cuh"

    # 22. B8 alone
    t = time.perf_counter()
    slow = b8_alone(device, card)
    print(f"phase 22: {time.perf_counter() - t:.1f} s")

    # 23. grid scans of S1-S3 at full width, f64 (B1) and f32 (B2)
    t = time.perf_counter()
    args = np.array(SPECIAL_ARGS)
    n = SPECIAL_N
    grid = {}
    for name in ("S1", "S2", "S3"):
        art = special[name]
        extent = S1_EXTENT if name == "S1" else S2_EXTENT
        check(art.uses_special_functions, f"{name}: the kernels would not run B8")
        al = GeneralisedAL(art, device=device, validate_basis=False)
        for precision, kernel in (("f64", "B1"), ("f32", "B2")):
            label = f"{name} complete_analysis {n}² {precision}"
            reset_counts()
            maps = torch.stack(al.complete_analysis(args, *extent, n, n, progress=False,
                                                    precision=precision, output="f64_device"))
            launches = launched(kernel, label)
            b8_total += launches
            check(maps.shape == (6, n, n) and bool(torch.isfinite(maps).any()),
                  f"{label}: maps {tuple(maps.shape)}")
            if precision == "f64":
                max_abs, _ = grid_check(art, "complete_analysis", args, extent, (n, n), "f64",
                                        maps, label, cpu_rtol=CPU_RTOL_SPECIAL)
            else:
                max_abs, _ = f32_check(art, "complete_analysis", args, extent, (n, n), maps,
                                       label)
            grid[(name, precision)] = (launches, max_abs)
            print(f"{label}: launches={launches} (B8 inside each); finite share "
                  f"{torch.isfinite(maps).double().mean().item():.6f}")
            del maps
        mp_grid_check(art, args, extent, n, device, f"{name} {n}² f64")
    al1 = GeneralisedAL(special["S1"], device=device, validate_basis=False)
    reset_counts()
    v = al1.calc_V_array(args, S1_EXTENT[::2], S1_EXTENT[1::2], [n, n])
    h = al1.calc_H_array(args, *S1_EXTENT, [n, n])
    launched("B1", "S1 calc_V_array/calc_H_array")
    check(np.array_equal(v, scan_cuda(special["S1"], "potential", args, S1_EXTENT, (n, n),
                                      device)[0].cpu().numpy(), equal_nan=True)
          and np.array_equal(h.reshape(4, n, n), scan_cuda(special["S1"], "hesse", args,
                                                           S1_EXTENT, (n, n), device).cpu()
                             .numpy(), equal_nan=True),
          "S1: calc_V_array/calc_H_array differ from the kernel's own")
    try:
        al1.complete_analysis(args, *S1_EXTENT, 64, 64, progress=False, precision="dd")
        raise SmokeFailure("S1 precision='dd' did not raise")
    except NotImplementedError as e:
        check("special function" in str(e), f"S1 dd: {e}")
        print(f"S1 precision='dd' raises: {e}")
    print(f"S1 calc_V_array/calc_H_array {n}²: the kernel's own; phase 23: "
          f"{time.perf_counter() - t:.1f} s")

    # 24. B5a over 1,048,576 points of S1's, S2's and S3's windows; S3's
    # also sorted by x[0]
    t = time.perf_counter()
    points = {}
    for name, extent in (("S1", S1_EXTENT), ("S2", S2_EXTENT), ("S3", S2_EXTENT)):
        rng = np.random.default_rng(24)
        pts = torch.tensor(np.stack([rng.uniform(extent[0], extent[1], SPECIAL_POINTS),
                                     rng.uniform(extent[2], extent[3], SPECIAL_POINTS)], 1),
                           device=device)
        al = GeneralisedAL(special[name], device=device, validate_basis=False)
        launches, max_abs = points_and_check(al, special[name], args, pts,
                                             f"{name} on-trajectory kinds at {SPECIAL_POINTS} "
                                             "points", cpu_rtol=CPU_RTOL_SPECIAL)
        b8_total += launches
        points[name] = (launches, max_abs, pts)
    art3, pts3 = special["S3"], points["S3"][2]
    order = torch.argsort(pts3[:, 0])
    pts3_sorted = pts3[order].contiguous()
    got = scan_points_cuda(art3, "complete_analysis", args, pts3)
    back = torch.empty_like(got)
    back[:, order] = scan_points_cuda(art3, "complete_analysis", args, pts3_sorted)
    check(bool(((back == got) | (back.isnan() & got.isnan())).all()),
          "S3 sorted by x[0]: the kernel's outputs, permuted back, differ from the random "
          "order's")
    random_ms, sorted_ms, windows, _, _ = adaptive_turns(
        lambda: scan_points_cuda(art3, "complete_analysis", args, pts3),
        lambda: scan_points_cuda(art3, "complete_analysis", args, pts3_sorted))
    import probe_grid_stages as probe  # the C entry without the coherence pass

    lib3, p3 = load_grid_scan(art3.cuda_source()), torch.tensor(args, device=device)
    nopass = probe.points(lib3, "complete_analysis", p3, pts3)
    check(bool(((nopass == got) | (nopass.isnan() & got.isnan())).all()),
          "S3: the scan without the coherence pass differs")
    unsorted_ms = time_ms(lambda: probe.points(lib3, "complete_analysis", p3, pts3), 20)
    probe._OUT.clear()
    print(f"B5a S3 complete_analysis at {SPECIAL_POINTS} points on {card}, through the "
          f"wrapper (the coherence pass first): random order {random_ms:.4f} ms (windows "
          f"{windows[0]:.4f}, {windows[1]:.4f}), sorted by x[0] {sorted_ms:.4f} ms (windows "
          f"{windows[2]:.4f}, {windows[3]:.4f}): random / sorted "
          f"{random_ms / sorted_ms:.3f}; the sorted scan's outputs, permuted back, bit for "
          f"bit the random order's; without the coherence pass (the C entry, random order) "
          f"{unsorted_ms:.4f} ms, bit for bit the same")
    del got, back
    print(f"phase 24: {time.perf_counter() - t:.1f} s")

    # 25. S2's background solves at cfg5d's width (B6)
    t = time.perf_counter()
    rng = np.random.default_rng(25)
    f0 = np.stack([rng.uniform(S2_EXTENT[0], S2_EXTENT[1], B_SOLVE),
                   rng.uniform(S2_EXTENT[2], S2_EXTENT[3], B_SOLVE)], 1)
    solve = special_solve_check(special["S2"], args, f0, STEPS,
                                f"S2 RKF45 {B_SOLVE} x {STEPS}", device, s2_parts)
    b8_total += solve["launches"]
    print(f"phase 25: {time.perf_counter() - t:.1f} s")

    # 26. S1's sweep over 8 values of a at 512², f64 (B7a) and f32 (B7b)
    t = time.perf_counter()
    sw = (SWEEP_N, SWEEP_N)
    a_values = np.linspace(1.0, 3.0, SPECIAL_SWEEP_SETS)[:, None]
    for precision, kernel, rtol in (("f64", "B7a", RTOL), ("f32", "B7b", None)):
        label = f"sweep S1 {SPECIAL_SWEEP_SETS} values of a x {SWEEP_N}² {precision}"
        reset_counts()
        maps = parameter_sweep(al1, a_values, S1_EXTENT, sw, progress=False, precision=precision)
        launches = launched(kernel, label)
        b8_total += launches
        got = scan_batch_cuda(special["S1"], "complete_analysis", a_values, S1_EXTENT, sw,
                              device, precision)
        check(np.array_equal(got.cpu().numpy(), maps, equal_nan=True),
              f"{label}: the user-facing call differs from the kernel's own")
        singles = min(compare(got[k], scan_cuda(special["S1"], "complete_analysis",
                                                a_values[k], S1_EXTENT, sw, device,
                                                precision), 0.0)[2]
                      for k in range(SPECIAL_SWEEP_SETS))
        check(singles == 1.0, f"{label}: a set differs from its single scan")
        if rtol is not None:
            rel, _, same = compare(got, scan_batch_torch(special["S1"], "complete_analysis",
                                                         a_values, S1_EXTENT, sw, device), rtol)
            note = f"kernel vs plain torch on the card max_rel={rel:.3e} bit_identical={same:.6f}"
        else:
            shares = [f32_check(special["S1"], "complete_analysis", a_values[k], S1_EXTENT, sw,
                                got[k], f"{label}, set {k}")[1] for k in range(SPECIAL_SWEEP_SETS)]
            note = f"each set vs plain f32 torch: share within rtol {RTOL_F32} at least " \
                   f"{min(shares):.6f}"
        print(f"{label}: launches={launches}; each set bit for bit its single scan; {note}")
        del maps, got
    print(f"phase 26: {time.perf_counter() - t:.1f} s")

    # 27. C9's Piecewise and sinc at 1024² through B1, B2 and B4
    t = time.perf_counter()
    for name in ("C9", "sinc"):
        al = GeneralisedAL(special[name], device=device, validate_basis=False)
        for precision, kernel in (("f64", "B1"), ("f32", "B2"), ("dd", "B4")):
            label = f"{name} complete_analysis {n}² {precision}"
            reset_counts()
            maps = torch.stack(al.complete_analysis(args, *PIECEWISE_EXTENT, n, n,
                                                    progress=False, precision=precision,
                                                    output="f64_device"))
            launched(kernel, label)
            if precision == "f32":
                f32_check(special[name], "complete_analysis", args, PIECEWISE_EXTENT, (n, n),
                          maps, label)
            else:
                grid_check(special[name], "complete_analysis", args, PIECEWISE_EXTENT, (n, n),
                           precision, maps, label, rows=16)
            del maps
    print(f"phase 27: {time.perf_counter() - t:.1f} s")

    # timing and the kernel table's rows
    for name in ("S1", "S2", "S3"):
        art = special[name]
        extent = S1_EXTENT if name == "S1" else S2_EXTENT
        for precision, kernel, source_kind, ops_per_s, size in (
                ("f64", "b1", "388", F64_OPS_PER_S, 8), ("f32", "b2", "231", F32_OPS_PER_S, 4)):
            timed_row(f"grid_scan_{kernel}_{precision}_{name.lower()}_{n}", grid_src,
                      f"{pk}:{source_kind}", *grid[(name, precision)],
                      direct_grid(art, "complete_analysis", args, extent, (n, n), device,
                                  precision),
                      lambda art=art, extent=extent, precision=precision: scan_torch(
                          art, "complete_analysis", args, extent, (n, n), device, precision),
                      6 * n * n * size, staged_ops(
                          art, "complete_analysis", precision, n, n,
                          special=grid_special_ops(art, "complete_analysis", args, extent, n,
                                                   device, precision)), ops_per_s)
    for name in ("S1", "S2", "S3"):
        art = special[name]
        launches, max_abs, pts = points[name]
        ms, plain_ms, windows, n_k, n_p = adaptive_turns(
            lambda: scan_points_cuda(art, "complete_analysis", args, pts),
            lambda: scan_points_torch(art, "complete_analysis", args, pts))
        sample = pts[:: SPECIAL_POINTS // SF_COUNT_N]
        p_dev = torch.tensor(args, device=device)
        b8_ops = fused_special_ops(art, "complete_analysis", list(sample.T),
                                   p_dev).double().mean().item()
        per_point = fused_point_ops(art, "complete_analysis", "f64", b8_ops)
        bnd = bound(SPECIAL_POINTS * (16 + 6 * 8), per_point * SPECIAL_POINTS)
        old_b8 = special_ops([art.potential, art._hesse, art.grad_square], list(sample.T),
                             p_dev).double().mean().item()
        old_bnd = bound(SPECIAL_POINTS * (16 + 6 * 8), point_ops(art, old_b8) * SPECIAL_POINTS)
        print(f"timing B5a {name} complete_analysis at {SPECIAL_POINTS} points on {card}: "
              f"kernel {ms:.4f} ms (windows {windows[0]:.4f}, {windows[1]:.4f}), plain torch "
              f"{plain_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}; {per_point:.2f} "
              f"operations a point, each distinct operation of the fused point function once, "
              f"of them B8's {b8_ops:.2f}, the mean over {len(sample)} of the points; counted "
              f"over the three model functions as before: {point_ops(art, old_b8):.2f} "
              f"operations, B8's {old_b8:.2f}, bound {old_bnd[0]:.4f} ms)")
        rows.append(row(f"points_scan_b5a_{name.lower()}_{SPECIAL_POINTS}", grid_src,
                        f"{pk}:1055", launches, max_abs, ms, plain_ms, bnd))
        point_bounds[f"B5a {name}"] = (pts, bnd, old_bnd)
    b6_row = row(f"solver_b6_rkf_s2_{B_SOLVE}x{STEPS}", "inflatox_torch/csrc/solver.cu",
                 "inflatox_tpu/ops/pallas_solver.py:173", solve["launches"], solve["max_abs"],
                 solve["ms"], solve["plain_ms"], solve["bound"])
    b6_row["note"] = (f"ms and bound: the whole {B_SOLVE} x {STEPS} launch; plain_ms and "
                      f"max_abs_err: its first {SPECIAL_SOLVE_ROWS} rows")
    rows.append(b6_row)
    b8_row = row("special_b8_eval", sf_src, f"{DF32_SPECIAL}:{B8_REPLACES[slow['fn']]}",
                 b8_total, slow["max_abs"], slow["ms"], slow["plain_ms"], slow["bound"])
    b8_row["library_ms"] = slow["library_ms"]
    b8_row["note"] = (f"launches: the grid, point and solver launches of phases 23-26's main "
                      f"paths, each running B8 inside; ms, plain_ms, max_abs_err and bound: "
                      f"phase 22's slowest case alone, {slow['label']}, {SF_N} arguments "
                      f"through csrc/special_eval.cu ({slow['launches']} launches there)")
    print(f"kernel B8 on the main paths of phases 23-26: {b8_total} launches of kernels that "
          f"ran it; alone (phase 22) the slowest case, {slow['label']}, in the table's "
          "special_b8_eval row")
    rows.append(b8_row)
    return rows, point_bounds


#: the grid-scan headers of the point paths (scripts/tree_headers.py's names)
PARENT_HEADERS = ("f64", "egno", "s1", "s2", "s3")


def start_parent_builds(parent):
    """Start nvcc, one per library, for the parent tree's grid-scan library
    of each point path's model (``parent``: the parent commit unpacked,
    e.g. with ``git archive``), each header generated by the tree's own
    package (scripts/tree_headers.py), into build/chip_smoke_parent/."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import probe_grid_stages as probe
    from tree_headers import tree_headers

    headers = tree_headers(parent, PARENT_HEADERS)
    csrc = os.path.join(parent, "inflatox_torch", "csrc")
    return {h: probe.start_build(os.path.join(HERE, "build", "chip_smoke_parent", h), headers[h],
                                 csrc, ()) for h in PARENT_HEADERS}


def parent_turns(jobs, cases, arts, card):
    """Each point path of the run, the parent tree's kernel and this
    checkout's, both through their library's C entry (this one's as the
    wrapper launches it: after the coherence pass on a special-function
    model) with parameters and outputs made beforehand, in two rounds of
    turns (parent, this, this, parent), outputs bit for bit equal; printed
    beside the bound counted over the fused point function's distinct work
    and the old count."""
    import numpy as np
    import torch

    import probe_grid_stages as probe
    from inflatox_torch.ops.build import load_grid_scan

    for label, header, args, pts, bnd, old in cases:
        parent = probe.finish_build(f"parent {header}", jobs[header])["lib"]
        art = arts[header]
        this = load_grid_scan(art.cuda_source("dd" if header == "egno" else "f64"))
        p = torch.tensor(np.asarray(args, dtype=np.float64), device=pts.device)
        runs = {tree: (lambda lib=lib: probe.points(lib, "complete_analysis", p, pts,
                                                    coherent=art.uses_special_functions))
                for tree, lib in (("parent", parent), ("this", this))}
        want = runs["this"]().clone()
        got = runs["parent"]()
        check(bool(((got == want) | (got.isnan() & want.isnan())).all()),
              f"{label}: the parent tree's kernel differs from this one")
        del want, got
        n = max(3, min(200, int(200 / max(probe.window_ms(runs["this"], 1), 1e-3))))
        windows = {"parent": [], "this": []}
        for tree in ("parent", "this", "this", "parent") * 2:
            windows[tree].append(probe.window_ms(runs[tree], n))
        ms = {tree: sum(w) / len(w) for tree, w in windows.items()}
        print(f"{label} complete_analysis at {pts.shape[0]} points in turns with the parent "
              f"tree on {card}: parent {ms['parent']:.4f} ms, this {ms['this']:.4f} ms "
              f"({ms['parent'] / ms['this']:.3f}x; windows " + ", ".join(
                  f"{tree} " + " ".join(f"{v:.4f}" for v in w) for tree, w in windows.items())
              + f"; {n} launches each, bit-identical); bound {bnd[0]:.4f} ms ({bnd[1]}) over "
              f"the fused point function's distinct work, {old[0]:.4f} ms ({old[1]}) counted "
              "over the three model functions as before")
        probe._OUT.clear()


# ------------------------------------------------------------------------- #
# phase 28: geometry, observables and fitting on the card                   #
# ------------------------------------------------------------------------- #


def cmb_models():
    """Phase 28's models: the α-attractor (``models.alpha_attractor``, the
    CMB workflow and the fit) and the hyperbolic plane g = diag(1, sinh²x)
    (tests/test_geometry.py:47-56, Ricci scalar −2)."""
    import sympy

    import inflatox_torch

    model, args = inflatox_torch.models.alpha_attractor()
    aa = inflatox_torch.Compiler(model, silent=True).compile()
    x, y, m = sympy.symbols("x y m", positive=True)
    hyperbolic = inflatox_torch.InflationModelBuilder.new(
        [x, y], [[sympy.Integer(1), 0], [0, sympy.sinh(x) ** 2]],
        sympy.Rational(1, 2) * m**2 * (x**2 + y**2), silent=True).build()
    return aa, args, inflatox_torch.Compiler(hyperbolic, silent=True).compile()


def host_clock_ms(fn, repeats=3):
    """Median host-clock ms of ``fn()`` over ``repeats`` calls after one
    warm-up, each started and ended synchronised."""
    import torch

    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times[1:])[len(times[1:]) // 2]


def close_values(got, want, rtol, floor=0.0):
    """Max relative error of two dicts (or arrays) of numbers, after
    requiring identical NaN masks and |got − want| <= rtol·|want| + floor
    everywhere."""
    import numpy as np

    if not isinstance(want, dict):
        got, want = {"": got}, {"": want}
    check(set(got) == set(want), f"keys {sorted(got)} against {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g = np.asarray(got[k].cpu() if hasattr(got[k], "cpu") else got[k], dtype=float)
        w = np.asarray(w.cpu() if hasattr(w, "cpu") else w, dtype=float)
        check(g.shape == w.shape, f"{k}: shape {g.shape} against {w.shape}")
        check(np.array_equal(np.isnan(g), np.isnan(w)), f"{k}: NaN masks differ")
        fin = np.isfinite(w)
        check(np.array_equal(g[~fin], w[~fin], equal_nan=True), f"{k}: ±inf differ")
        diff = np.abs(g[fin] - w[fin])
        check(bool((diff <= rtol * np.abs(w[fin]) + floor).all()),
              f"{k}: beyond rtol {rtol} (floor {floor:.3e}): max diff {diff.max():.3e}")
        nz = np.abs(w[fin]) > 0
        if nz.any():
            worst = max(worst, float((diff[nz] / np.abs(w[fin][nz])).max()))
    return worst


def slot_of(art, name):
    import sympy

    slot = art.lookup_symbol(sympy.Symbol(name))
    return int(slot[slot.index("[") + 1:-1])


def cmb_phase(art, args, al, aa, aa_args, hyperbolic, s2, device, card):
    """Phase 28: geometry, observables and fitting on the card (see the
    module docstring); returns {"B6": launches, "B1": launches} of its
    paths."""
    import glob

    import numpy as np
    import torch

    from inflatox_torch import background
    from inflatox_torch import observables as ob
    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.grid import axis_coords

    launches = {}
    f0 = [0.99, 0.5]  # tests/test_observables.py:382-410

    # background (kernel B6) and the CMB pivot, each function on the card
    # held against device="cpu" on the same rows
    cuda_kernels.LAUNCHES_BY_KERNEL["B6"] = 0
    t = time.perf_counter()
    rows, times = background.solve_eom(aa, aa_args, CMB_STEPS, f0, [0.0, 0.0], max_err=1e-9,
                                       solver="rkf", return_time=True, device=device)
    solve_s = time.perf_counter() - t
    b6 = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    check(b6 == 1, f"α-attractor solve: {b6} B6 launches")
    check(bool(np.isfinite(rows).all()) and bool((np.diff(times) > 0).all()),
          "α-attractor solve: non-finite rows or times not increasing")
    print(f"α-attractor solve_eom(solver='rkf', max_err=1e-9) {CMB_STEPS} rows on kernel B6: "
          f"{solve_s:.3f} s host clock (first call) on {card}; t_end {times[-1]:.6e}")
    calls = {
        "horizon_exit": lambda dev: ob.horizon_exit(aa, rows, times, aa_args, device=dev),
        "power_spectrum": lambda dev: ob.power_spectrum(aa, rows, times, aa_args, device=dev),
        "cobe_normalize": lambda dev: ob.cobe_normalize(aa, rows, times, aa_args, device=dev),
        "n_star_matching": lambda dev: ob.n_star_matching(aa, aa_args, rows, times, A_s=2.1e-9,
                                                          device=dev),
    }
    outs = {}
    for name, call in calls.items():
        outs[name] = call(device)
        rel = close_values(outs[name], call("cpu"), RTOL_CMB)
        print(f"{name} on the card vs device='cpu' on the same rows: max_rel={rel:.3e} "
              f"(rtol {RTOL_CMB}); {host_clock_ms(lambda: call(device)):.3f} ms host clock, median "
              f"of 3, on {card}")
    pivot = outs["horizon_exit"]
    print(f"α-attractor pivot 55 e-folds before the end: x = {pivot['x'].tolist()}, "
          f"N_end {pivot['N_end']:.6f}, n_s {pivot['n_s']:.8f}, r {pivot['r']:.6e}; "
          f"N_* (A_s 2.1e-9, instant reheating) {outs['n_star_matching']['N_star']:.6f}")
    args2 = aa_args.copy()
    args2[slot_of(aa, "M4")] *= outs["cobe_normalize"]["scale"]
    rows2, times2 = background.solve_eom(aa, args2, CMB_STEPS, f0, [0.0, 0.0], max_err=1e-9,
                                         solver="rkf", return_time=True, device=device)
    again = ob.cobe_normalize(aa, rows2, times2, args2, device=device)
    check(abs(again["P_zeta"] / 2.1e-9 - 1.0) <= 1e-4,
          f"COBE round trip: P_zeta {again['P_zeta']!r} after rescaling M4")
    launches["B6"] = cuda_kernels.LAUNCHES_BY_KERNEL["B6"]
    check(launches["B6"] == 2, f"phase 28's solves: {launches['B6']} B6 launches")
    print(f"COBE round trip: scale {outs['cobe_normalize']['scale']:.10e}, re-solved on B6: "
          f"P_zeta {again['P_zeta']:.10e} (within {abs(again['P_zeta'] / 2.1e-9 - 1):.2e} of "
          f"2.1e-9), scale {again['scale']:.10f}; B6 launches in phase 28: {launches['B6']}")

    n = GEO_N
    # a profiling.trace around one B1 complete_analysis at 4096², in a fresh
    # process (``--trace-worker``): in this one, after phases 1-27, the
    # profiler's CUDA activity came back empty (PERF.md §7)
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    worker = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-worker",
                             PROFILE_DIR], capture_output=True, text=True, timeout=600)
    check(worker.returncode == 0, f"trace worker: exit {worker.returncode}: "
          f"{worker.stderr.strip()[-500:]}")
    launches["B1"] = json.loads(worker.stdout.strip().splitlines()[-1])["B1"]
    check(launches["B1"] == 1, f"profiled complete_analysis: {launches['B1']} B1 launches")
    files = glob.glob(os.path.join(PROFILE_DIR, "phase28*.pt.trace.json"))
    check(len(files) == 1, f"profiling.trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    b1 = [e for e in events if "grid_scan_kernel" in str(e.get("name", ""))
          and e.get("cat") == "kernel"]
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    check(len(b1) == 1, f"the trace names B1's kernel {len(b1)} times (its events by "
          f"category: {cats})")
    check(any(e.get("name") == "inflatox_complete_analysis" for e in events),
          "the trace lacks the annotated region")
    print(f"profiling.trace: {os.path.relpath(files[0], HERE)} "
          f"({os.path.getsize(files[0])} bytes, {len(events)} events) names B1's kernel "
          f"{b1[0]['name'][:80]!r}: {b1[0].get('dur')} us on {card}")
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)

    # slow roll over cfg1's 4096² hyperinflation grid
    x0 = axis_coords(DOC_EXTENT[0], DOC_EXTENT[1], n, device).reshape(n, 1)
    x1 = axis_coords(DOC_EXTENT[2], DOC_EXTENT[3], n, device).reshape(1, n)
    sr = ob.slow_roll(art, device=device)
    maps = sr([x0, x1], args)
    check(all(v.shape == (n, n) and v.device.type == "cuda" for v in maps.values()),
          "slow_roll: maps of the wrong shape or device")
    cpu = ob.slow_roll(art, device="cpu")([x0[:64].cpu(), x1.cpu()], args)
    rels = {k: compare(maps[k][:64].cpu(), cpu[k], RTOL_CMB)[0] for k in maps}
    sr_ms = time_ms(lambda: sr([x0, x1], args), 5, 1)
    print(f"slow_roll over hyperinflation {n}² (bench cfg1's grid) on {card}: "
          f"{sr_ms:.3f} ms (CUDA events, 5 calls); finite share of ε_V "
          f"{torch.isfinite(maps['epsilon_v']).double().mean().item():.6f}; rows 0-63 vs "
          "device='cpu': " + ", ".join(f"{k} max_rel={v:.3e}" for k, v in rels.items()))
    del maps

    # geometry over a 4096² grid of the hyperbolic plane
    gx = axis_coords(HYPERBOLIC_EXTENT[0], HYPERBOLIC_EXTENT[1], n, device).reshape(n, 1)
    gy = axis_coords(HYPERBOLIC_EXTENT[2], HYPERBOLIC_EXTENT[3], n, device).reshape(1, n)
    gp = torch.tensor([1.3], dtype=torch.float64, device=device)
    geo = hyperbolic.geometry
    ric = geo.ricci_scalar([gx, gy], gp)
    check(ric.shape == (n, n) and bool(((ric + 2.0).abs() <= 2e-12).all()),
          "hyperbolic plane: Ricci scalar not −2 within 1e-12")
    gam = geo.christoffels([gx, gy], gp)
    check(gam.shape == (2, 2, 2, n, n), f"christoffels of shape {tuple(gam.shape)}")
    sh, ch = torch.sinh(gx[:, 0]), torch.cosh(gx[:, 0])
    rel_g = max(compare(gam[1, 0, 1][:, 0], ch / sh, 1e-12)[0],
                compare(gam[0, 1, 1][:, 0], -sh * ch, 1e-12)[0])
    del gam
    riem = geo.riemann([gx, gy], gp)
    g_yy = (sh * sh)
    # constant curvature K = −1: R^x_yxy = K g_yy, R^y_xyx = K g_xx
    rel_r = max(compare(riem[0, 1, 0, 1][:, 0], -g_yy, 1e-12)[0],
                compare(riem[1, 0, 1, 0][:, 0], -torch.ones_like(g_yy), 1e-12)[0])
    del riem
    geo_ms, geo_rel = {}, {}
    for surface in ("christoffels", "riemann", "ricci_scalar", "hesse"):
        fn = getattr(geo, surface)
        got = fn([gx[:64], gy], gp)
        want = fn([gx[:64].cpu(), gy.cpu()], gp.cpu())
        geo_rel[surface] = close_values(got, want, RTOL_CMB,
                                        1e-13 * float(want.abs().max()))
        geo_ms[surface] = time_ms(lambda fn=fn: fn([gx, gy], gp), 3, 1)
        torch.cuda.empty_cache()
    print(f"geometry over the hyperbolic plane {n}² on {card}: R = −2 everywhere; "
          f"Γ^y_xy, Γ^x_yy against coth x, −sinh x cosh x: max_rel={rel_g:.3e}; R^x_yxy, "
          f"R^y_xyx against the constant-curvature identity: max_rel={rel_r:.3e}; rows 0-63 vs "
          "device='cpu': " + ", ".join(f"{k} max_rel={v:.3e}" for k, v in geo_rel.items())
          + "; ms per call (CUDA events, 3 calls): "
          + ", ".join(f"{k} {v:.3f}" for k, v in geo_ms.items()))

    # forecasting: Jacobians and Fisher matrices, card against CPU
    keys = ("epsilon_v", "eta_v", "n_s", "r")
    sigma = np.array([0.004, 0.01])
    for name, m_art, m_args, x in (("hyperinflation", art, args, [2.0, 2.0]),
                                   ("S2", s2, np.array(SPECIAL_ARGS), [1.3, 0.7]),
                                   ("α-attractor", aa, aa_args, pivot["x"])):
        jac = ob.observable_jacobian(m_art, keys, device=device)
        j_card = jac(x, m_args)
        check(j_card.device.type == "cuda", f"{name}: Jacobian left the card")
        j_cpu = ob.observable_jacobian(m_art, keys, device="cpu")(x, m_args)
        size = max(1.0, max(abs(float(v)) for v in ob.slow_roll(m_art, device="cpu")(
            x, m_args).values()))
        scale = torch.tensor(np.abs(m_args))
        rel_j = close_values(j_card.cpu() * scale, j_cpu * scale, 1e-10, 1e-12 * size)
        f_card = ob.fisher_matrix(m_art, x, m_args, sigma, device=device)
        f_cpu = ob.fisher_matrix(m_art, x, m_args, sigma, device="cpu")
        outer = np.outer(np.abs(m_args), np.abs(m_args))
        floor = 1e-12 * size * max(1.0, float((j_cpu * scale).abs().max())) / sigma.min() ** 2
        rel_f = close_values(f_card * outer, f_cpu * outer, 1e-10, floor)
        print(f"forecast {name} at x = {np.asarray(x).tolist()}: Jacobian "
              f"{np.round(j_card.cpu().numpy(), 10).tolist()}, card vs CPU max_rel={rel_j:.3e}; "
              f"Fisher card vs CPU max_rel={rel_f:.3e}; jac {host_clock_ms(lambda: jac(x, m_args)):.3f} "
              f"ms host clock on {card}")

    # the fixed-step solver: rows against the CPU, a value and gradient
    # against central differences, forward and backward timed
    grid = np.linspace(0.0, FIXED_T, FIXED_POINTS)
    x_init, d_init = np.array([2.0, 2.0]), np.array([0.0, 0.0])

    def value(m_args, x_start, dev=device):
        rows_f = ob.solve_eom_fixed(art, m_args, grid, x_start, d_init, device=dev)
        return rows_f, rows_f[-1, 0] * rows_f[-1, 1] + rows_f[-1, 4]

    p = torch.tensor(args, device=device, requires_grad=True)
    xs = torch.tensor(x_init, device=device, requires_grad=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rows_f, target = value(p, xs)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    t = time.perf_counter()
    target.backward()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t
    check(rows_f.shape == (FIXED_POINTS, 5) and bool(torch.isfinite(rows_f).all()),
          "solve_eom_fixed: rows of the wrong shape or not finite")
    t = time.perf_counter()
    rows_cpu, _ = value(args, x_init, "cpu")
    cpu_s = time.perf_counter() - t
    rel_rows = close_values(rows_f.detach().cpu(), rows_cpu, RTOL_CMB)
    direction = np.array([0.6, 0.48, -0.64])  # over (m, x0[0], x0[1])
    grad = np.concatenate([p.grad.cpu().numpy(), xs.grad.cpu().numpy()])
    h = 1e-6
    with torch.no_grad():  # on the CPU, which the rows equal within RTOL_CMB
        up = float(value(args + h * direction[:1], x_init + h * direction[1:], "cpu")[1])
        down = float(value(args - h * direction[:1], x_init - h * direction[1:], "cpu")[1])
    fd = (up - down) / (2 * h)
    check(abs(fd - grad @ direction) <= 1e-5 * abs(fd), f"solve_eom_fixed: gradient "
          f"{grad @ direction!r} against central differences {fd!r}")
    short = np.linspace(0.0, FIXED_T, FIXED_COUNT_POINTS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ob.solve_eom_fixed(art, args, short, x_init, d_init, device=device)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    per_step = kernels / (FIXED_COUNT_POINTS - 1)
    print(f"solve_eom_fixed hyperinflation over {FIXED_POINTS} points (RK4, {FIXED_POINTS - 1} "
          f"steps) on {card}: forward {fwd_s * 1e3:.1f} ms, backward {bwd_s * 1e3:.1f} ms "
          f"(host clock, first call, synchronised); CPU forward {cpu_s * 1e3:.1f} ms; "
          f"{per_step:.1f} kernel launches a step ({kernels} over {FIXED_COUNT_POINTS - 1} "
          f"steps, torch.profiler's cudaLaunchKernel count); "
          f"rows vs device='cpu' max_rel={rel_rows:.3e}; directional gradient "
          f"{grad @ direction:.12e} vs central differences {fd:.12e} "
          f"(rel {abs(fd - grad @ direction) / abs(fd):.2e})")
    del rows_f, target

    # a 64-start fit of the α-attractor's (c, α) to its own (n_s, r) at the
    # pivot, card against CPU
    x_star = torch.tensor(pivot["x"], device=device)
    truth = ob.slow_roll(aa, device=device)(x_star, aa_args)
    order = [slot_of(aa, s) for s in ("M4", "c", "alpha")]
    check(order == [0, 1, 2], f"α-attractor parameter slots {order}")

    def make_loss(dev):
        sr_dev = ob.slow_roll(aa, device=dev)
        xs_dev, m4 = x_star.to(dev), torch.tensor(aa_args[:1], device=dev)
        ns_t, r_t = truth["n_s"].to(dev), truth["r"].to(dev)

        def loss(q):
            got = sr_dev(xs_dev, torch.cat([m4, q]))
            return ((got["n_s"] - ns_t) / 0.004) ** 2 + ((got["r"] - r_t) / 0.01) ** 2

        return loss

    rng = np.random.default_rng(28)
    starts = np.stack([rng.uniform(0.02, 0.3, FIT_STARTS), rng.uniform(0.3, 3.0, FIT_STARTS)], 1)
    loss_card = make_loss(device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit = ob.fit_parameters(loss_card, starts, steps=FIT_STEPS, device=device)
    fit_s = time.perf_counter() - t
    t = time.perf_counter()
    fit_cpu = ob.fit_parameters(make_loss("cpu"), starts, steps=FIT_STEPS, device="cpu")
    fit_cpu_s = time.perf_counter() - t
    check(fit.loss_history.shape == (FIT_STARTS, FIT_STEPS), "fit: history of the wrong shape")
    rel_h = close_values(fit.loss_history, fit_cpu.loss_history, 1e-9,
                         1e-12 * float(fit_cpu.loss_history[:, 0].max()))
    rel_p = close_values(fit.params, fit_cpu.params, 1e-8)
    best = int(fit.loss_history[:, -1].argmin())
    final = float(loss_card(torch.tensor(fit.params[best], device=device)))
    check(final < 1e-6, f"fit: best start's final loss {final!r}")
    print(f"fit_parameters α-attractor (c, α), {FIT_STARTS} starts x {FIT_STEPS} steps (Adam, "
          f"lr 0.05) on {card}: {fit_s:.3f} s ({fit_s / FIT_STEPS * 1e3:.3f} ms a step, host "
          f"clock, first call), CPU {fit_cpu_s:.3f} s; history vs CPU max_rel={rel_h:.3e}, "
          f"params max_rel={rel_p:.3e}; best start {best}: (c, α) = "
          f"{fit.params[best].tolist()}, final loss {final:.3e}; "
          f"{int((fit.loss_history[:, -1] < 1e-6).sum())} starts below 1e-6")

    return launches


# ------------------------------------------------------------------------- #
# phase 29: perturbation spectra on the card                                #
# ------------------------------------------------------------------------- #


def spectra_models():
    """Phase 29's models: bench's quadratic (bench.py:308-320: ½(m₁φ₁)² +
    ½(m₂φ₂)² on a flat metric) and the curved two-field model of
    tests/test_perturbations.py:34-48 (metric diag(1, e^{2bφ₁}), m₁ = 1,
    m₂ = 0.8, b = 0.25)."""
    import sympy

    import inflatox_torch

    p1, p2, m1, m2, b = sympy.symbols("p1 p2 m1 m2 b", real=True)
    V = sympy.Rational(1, 2) * (m1 * p1) ** 2 + sympy.Rational(1, 2) * (m2 * p2) ** 2
    built = []
    for metric in ([[1, 0], [0, 1]], [[sympy.Integer(1), 0], [0, sympy.exp(2 * b * p1)]]):
        model = inflatox_torch.InflationModelBuilder.new([p1, p2], metric, V, silent=True).build()
        built.append(inflatox_torch.Compiler(model, silent=True).compile())
    quad, curved = built
    c_args = inflatox_torch.models._args_by_symbol(curved.model,
                                                   {"m1": 1.0, "m2": 0.8, "b": 0.25})
    return quad, curved, c_args


class SolveTap:
    """Wraps ``background.solve_eom_batch`` inside a ``with`` block: records
    each call's arguments and results, or, given recorded calls, checks that
    the starts are the recorded ones and returns the recorded results (so
    that the CPU side of a comparison reads the card's base rows)."""

    def __init__(self, replay=None):
        self.calls = [] if replay is None else list(replay)
        self.replay = replay is not None

    def __enter__(self):
        import numpy as np

        from inflatox_torch import background

        self._real = background.solve_eom_batch

        def call(artifact, pars, steps, f0, chi0, **kw):
            if self.replay:
                args, out = self.calls.pop(0)
                check(np.array_equal(args[3], f0) and np.array_equal(args[1], pars),
                      "replayed solve: other starts than the recorded ones")
                return out
            out = self._real(artifact, pars, steps, f0, chi0, **kw)
            self.calls.append(((artifact, pars, steps, f0, chi0), out))
            return out

        background.solve_eom_batch = call
        return self

    def __exit__(self, *exc):
        from inflatox_torch import background

        background.solve_eom_batch = self._real
        check(exc[0] is not None or not (self.replay and self.calls),
              "replayed solves left over")


def step_cost(run):
    """(kernel launches a step, ms a step) of an RK4 loop ``run(n)`` over its
    first n steps: launches from torch.profiler's count of launch calls over
    STEPS_COUNTED steps, time on the host clock over STEPS_TIMED steps,
    synchronised."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(STEPS_COUNTED)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages() if "LaunchKernel" in e.key}
    t = time.perf_counter()
    run(STEPS_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / STEPS_TIMED
    return sum(counts.values()) / STEPS_COUNTED, ms, counts


def spectra_phase(quad, curved, c_args, device, card):
    """Phase 29: perturbation spectra on the card (see the module docstring);
    returns (B6 launches on its paths, a summary of its numbers)."""
    import numpy as np
    import torch

    from inflatox_torch import background
    from inflatox_torch import perturbations as pert
    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_solver import solve_cuda

    launches = {}
    summary = {"card": card}
    f0, d0 = [12.0, 0.0], [0.0, 0.0]

    def counted(label, expected, fn):
        cuda_kernels.LAUNCHES_BY_KERNEL["B6"] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        check(cuda_kernels.LAUNCHES_BY_KERNEL["B6"] == expected,
              f"{label}: {cuda_kernels.LAUNCHES_BY_KERNEL["B6"]} B6 launches, expected {expected}")
        launches[label] = expected
        return out, seconds

    def held(got, want, keys, rtol, floor_keys=(), scaled=("N_grad", "N_hess")):
        """Max relative error over ``keys``; the δN derivatives, whose
        spectator components vanish by symmetry, within rtol of their
        largest component."""
        rel = 0.0
        for k in keys:
            floor = FLOOR_SPECTRA if k in floor_keys else 0.0
            if k in scaled:
                floor = rtol * float(np.nanmax(np.abs(want[k])))
            rel = max(rel, close_values(got[k], want[k], rtol, floor))
        return rel

    first = ("ln_k", "N", "P_zeta", "P_tensor", "n_s", "r", "H", "N_grad")

    # cfg6: delta_n_sweep, 16 mass sets, two B6 launches (16 base and 512
    # perturbed trajectories × 2000 rows), against the plain solver on the CPU
    pars6 = np.stack([np.linspace(0.9, 1.1, DN_SETS), np.ones(DN_SETS)], 1)

    def dn_sweep(dev=device):
        return pert.delta_n_sweep(quad, pars6, f0, d0, max_err=1e-8, device=dev, **SPECTRA_KW)

    with SolveTap() as tap:
        sw, first_s = counted("cfg6 delta_n_sweep", 2, dn_sweep)
    check(bool(sw["ok"].all()) and sw["P_zeta"].shape == (DN_SETS, SPECTRA_KW["pivots"]),
          f"cfg6: ok {sw['ok'].tolist()}, P_zeta {sw['P_zeta'].shape}")
    t = time.perf_counter()
    sw_cpu = dn_sweep("cpu")
    cpu_s = time.perf_counter() - t
    rel6 = held(sw, sw_cpu, first, RTOL_DN_FIRST)
    cfg6_ms = host_clock_ms(dn_sweep, 3)
    # its parts: the perturbed launch alone (CUDA events), the copy of its
    # rows to the host, the rest host numpy
    (_, pars_all, steps, f_all, c_all), _ = tap.calls[1]
    pt, ft, ct = (torch.tensor(np.ascontiguousarray(a), device=device)
                  for a in (pars_all, f_all, c_all))
    b6_ms = time_ms(lambda: solve_cuda(quad, pt, steps, ft, ct, 1e-8, "rkf"), 10, 2)
    rows_t, times_t = solve_cuda(quad, pt, steps, ft, ct, 1e-8, "rkf")
    torch.cuda.synchronize()
    t = time.perf_counter()
    rows_np, times_np = background._host(rows_t, times_t, True)
    copy_ms = (time.perf_counter() - t) * 1e3
    n_rows = rows_np.nbytes + times_np.nbytes
    # the host part after the copy: Ḣ by the inner product on the card
    # (the rows go back to it) with the e-fold axis, then the surface
    # read-out in numpy
    t = time.perf_counter()
    aux = pert._batch_hdot_efolds(quad, pars_all, rows_np, times_np, device)
    hdot_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pert._dn_surface(quad, pars_all, rows_np, times_np, rows_np[:, 0, -1] * 0.5, steps, device,
                     strict=False, aux=aux)
    surface_ms = (time.perf_counter() - t) * 1e3
    print(f"cfg6 delta_n_sweep {DN_SETS} sets x {SPECTRA_KW['pivots']} pivots on {card}: "
          f"{cfg6_ms:.1f} ms host clock, median of 3 ({DN_SETS / cfg6_ms * 3.6e6:.0f} sets an "
          f"hour; first call {first_s * 1e3:.1f} ms); B6 launches 2 ({pars6.shape[0]} base, "
          f"{f_all.shape[0]} perturbed trajectories x {steps} rows); the perturbed launch alone "
          f"{b6_ms:.3f} ms (CUDA events), its rows to the host {copy_ms:.1f} ms ({n_rows} "
          f"bytes), then Ḣ and the e-fold axis {hdot_ms:.1f} ms (the rows back to the card "
          f"for the inner product) and the surface read-out {surface_ms:.1f} ms (numpy), "
          f"host clock; card vs device='cpu' (the plain solver): max_rel={rel6:.3e} (rtol "
          f"{RTOL_DN_FIRST}); CPU {cpu_s:.1f} s")
    summary["cfg6"] = {"ms": cfg6_ms, "first_ms": first_s * 1e3, "b6_perturbed_ms": b6_ms,
                       "copy_ms": copy_ms, "copy_bytes": n_rows, "hdot_efolds_ms": hdot_ms,
                       "surface_ms": surface_ms, "cpu_s": cpu_s,
                       "max_rel_cpu": rel6, "trajectories": int(f_all.shape[0])}

    # cfg6b and cfg6c: mode_sweep and transport_sweep, 8 sets x 8 pivots at
    # the default 4000 + 1500 steps; the CPU side reads the card's base rows
    pars6b = np.stack([np.linspace(0.9, 1.1, MODE_SETS), np.ones(MODE_SETS)], 1)
    mode_keys = ("ln_k", "N", "P_zeta", "P_tensor", "P_iso", "cos_delta", "n_s", "n_t",
                 "alpha_s", "r", "H")
    for name, fn, keys in (
            ("cfg6b mode_sweep", pert.mode_sweep, mode_keys),
            ("cfg6c transport_sweep", pert.transport_sweep,
             mode_keys + ("T_RS", "T_SS", "P_zeta_star", "P_iso_star"))):
        fn(quad, pars6b, f0, d0, device=device, **dict(SPECTRA_KW, pivots=3))  # untimed
        with SolveTap() as tap:
            out, seconds = counted(name, 1, lambda fn=fn: fn(quad, pars6b, f0, d0,
                                                             device=device, **SPECTRA_KW))
        check(bool(out["ok"].all()) and bool(np.isfinite(out["P_zeta"]).all()),
              f"{name}: ok {out['ok'].tolist()} or non-finite P_zeta")
        t = time.perf_counter()
        with SolveTap(replay=tap.calls):
            cpu = fn(quad, pars6b, f0, d0, device="cpu", **SPECTRA_KW)
        cpu_s = time.perf_counter() - t
        rel = held(out, cpu, keys, RTOL_SPECTRA, ("cos_delta", "T_RS"))
        print(f"{name} {MODE_SETS} sets x {SPECTRA_KW['pivots']} pivots (4000 + 1500 RK4 "
              f"steps) on {card}: {seconds:.2f} s host clock (after an untimed call at 3 "
              f"pivots), {MODE_SETS / seconds * 3600:.0f} sets an hour; B6 launches 1; card "
              f"vs device='cpu' on the same base rows max_rel={rel:.3e} (rtol {RTOL_SPECTRA}); "
              f"CPU {cpu_s:.2f} s; P_zeta set 0 {out['P_zeta'][0].tolist()}")
        summary[name.split()[0]] = {"s": seconds, "cpu_s": cpu_s, "max_rel_cpu": rel}

    # the integrators: kernel launches and ms a step over cfg6b's 64 pivots
    _, setups, _ = pert._sweep_base_setups(
        quad, pars6b, f0, d0, steps=SPECTRA_KW["steps"], max_err=1e-8, solver="rkf",
        device=device, on_failure="raise", pivots=SPECTRA_KW["pivots"],
        N_margin_start=SPECTRA_KW["N_margin_start"], N_margin_end=SPECTRA_KW["N_margin_end"],
        N_sub=4.0, N_dense=2.0, dense_steps=4000, tail_steps=1500)
    ms_streams = [pert._ms_streams(s) for s in setups]
    scalar = tuple(torch.cat(p, 1) for p in zip(*[st[0] for st in ms_streams]))
    tensor = tuple(torch.cat(p, 1) for p in zip(*[st[1] for st in ms_streams]))
    u_n, u_m, u_t_n, u_t_m, dts = (torch.cat(p, 1) for p in
                                   zip(*[pert._tr_streams(s) for s in setups]))
    state0 = torch.cat([s.state0 for s in setups])
    state0_t = torch.tensor(np.concatenate([s.state0_t for s in setups]), device=device)
    sig0s = [pert._tr_sigma0(s) for s in setups]
    sig0, sig0_t = torch.cat([a for a, _ in sig0s]), torch.cat([b for _, b in sig0s])

    def cut(streams, n):
        return tuple(s[:n + 1] for s in streams[:-1]) + (streams[-1][:n],)

    loops = {
        "mode scalar": lambda n: pert._ms_integrate(state0, cut(scalar, n)),
        "mode tensor": lambda n: pert._ms_integrate_t(state0_t, cut(tensor, n)),
        "transport scalar": lambda n: pert._tr_integrate(sig0, u_n, u_m, dts, 0, n),
        "transport tensor": lambda n: pert._tr_integrate(sig0_t, u_t_n, u_t_m, dts, 0, n),
    }
    summary["steps"] = {}
    for name, run in loops.items():
        per_step, ms, counts = step_cost(run)
        summary["steps"][name] = {"launches": per_step, "ms": ms}
        print(f"RK4 step, {name}, {state0.shape[0]} pivots on {card}: {per_step:.2f} kernel "
              f"launches a step (torch.profiler over {STEPS_COUNTED} steps: {counts}), "
              f"{ms:.4f} ms a step (host clock over {STEPS_TIMED} steps, synchronised), "
              f"{ms * 1e3 / max(per_step, 1):.2f} us a launch")
    del ms_streams, scalar, tensor, u_n, u_m, u_t_n, u_t_m, setups

    # the curved two-field model: its base on B6, then every route on the
    # card against device="cpu" on the same rows
    (rows, times), base_s = counted("curved solve_eom", 1, lambda: background.solve_eom(
        curved, c_args, CURVED_STEPS, [10.0, 1.5], [0.0, 0.0], max_err=1e-9, solver="rkf",
        return_time=True, device=device))
    check(bool(np.isfinite(rows).all()), "curved base: non-finite rows")
    routes = {
        "delta_n_spectrum(order=2)": (
            lambda k, dev: pert.delta_n_spectrum(
                curved, c_args, rows, times, pivots=k, order=2, N_margin_start=5.0,
                N_margin_end=5.0, steps=CURVED_STEPS, max_err=1e-9, device=dev), 1),
        "mode_spectrum": (lambda k, dev: pert.mode_spectrum(curved, c_args, rows, times,
                                                            pivots=k, device=dev), 0),
        "transport_spectrum": (lambda k, dev: pert.transport_spectrum(
            curved, c_args, rows, times, pivots=k, device=dev), 0),
    }
    outs = {}
    for name, (fn, n_b6) in routes.items():
        fn(3, device)  # untimed
        outs[name], seconds = counted(f"curved {name}", n_b6, lambda fn=fn: fn(12, device))
        t = time.perf_counter()
        cpu = fn(12, "cpu")
        cpu_s = time.perf_counter() - t
        if n_b6:
            second = ("N_hess", "f_NL")
            rel = max(held(outs[name], cpu, first, RTOL_DN_FIRST),
                      held(outs[name], cpu, second, RTOL_DN_SECOND))
            tol = f"rtol {RTOL_DN_FIRST}, N_hess and f_NL {RTOL_DN_SECOND}; the plain solver"
        else:
            rel = held(outs[name], cpu, list(cpu), RTOL_SPECTRA, ("cos_delta", "T_RS"))
            tol = f"rtol {RTOL_SPECTRA}, same rows"
        summary[f"curved {name}"] = {"s": seconds, "cpu_s": cpu_s, "max_rel_cpu": rel}
        print(f"curved {name} at 12 pivots on {card}: {seconds:.3f} s host clock (after an "
              f"untimed call at 3 pivots); B6 launches {n_b6}; card vs device='cpu' "
              f"max_rel={rel:.3e} ({tol}); CPU {cpu_s:.2f} s")
    dn, ms, tr = (outs[k] for k in routes)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pert._pivot_setup(curved, c_args, rows, times, 12, 5.0, 5.0, 4.0, 2.0, 4000, 1500, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    summary["curved pivot setup s"] = setup_s
    print(f"curved mode/transport pivot setup alone (12 pivots: grids, the streams' Γu and "
          f"M/H² on the card, the vielbein start) on {card}: {setup_s:.3f} s host clock; the "
          "rest of each call is its RK4 loops and the numpy read-out")
    n_end = dn["N"][-1] + 5.0
    settled = n_end - ms["N"] >= 8.0  # tests/test_perturbations.py places them 8 before
    ratio = ms["P_zeta"] / dn["P_zeta"] - 1.0
    check(bool(np.allclose(ms["N"], dn["N"], rtol=0, atol=1e-12)), "curved: pivots differ")
    check(bool((np.abs(ratio[settled]) <= 0.08).all()),
          f"curved: mode against δN {ratio.tolist()}")
    print(f"curved mode_spectrum against delta_n_spectrum at the same 12 pivots on {card}: "
          f"P_zeta ratio - 1 = {np.round(ratio, 5).tolist()} (within 8 % at the "
          f"{int(settled.sum())} pivots 8 or more e-folds before the end, as "
          f"tests/test_perturbations.py places them); transport/mode - 1 "
          f"{np.abs(tr['P_zeta'] / ms['P_zeta'] - 1).max():.3e} at most; δN f_NL "
          f"{np.round(dn['f_NL'], 6).tolist()}")

    sq_kw = dict(steps=CURVED_STEPS, max_err=1e-9, N_margin_start=2.0, N_margin_end=5.0)

    def squeezed(dev=device):
        return pert.squeezed_fnl(curved, c_args, rows, times, N_long_before_end=22.0,
                                 N_short_before_end=(14.0,), device=dev, **sq_kw)

    squeezed()  # untimed
    sq, sq_s = counted("curved squeezed_fnl", 2, squeezed)
    t = time.perf_counter()
    sq_cpu = squeezed("cpu")
    sq_cpu_s = time.perf_counter() - t
    rel_sq = max(held(sq, sq_cpu, ("N_grad_long", "P_zeta_long", "P_zeta_short", "ln_k_short"),
                      RTOL_DN_FIRST),
                 held(sq, sq_cpu, ("f_NL_sq", "response"), RTOL_DN_SECOND))
    dn3, _ = counted("curved delta_n_spectrum at 15, 14, 13 e-folds", 1, lambda: (
        pert.delta_n_spectrum(curved, c_args, rows, times, pivot_N_before_end=[15.0, 14.0, 13.0],
                              order=2, device=device, **sq_kw)))
    consistency = (5.0 / 12.0) * (1.0 - dn3["n_s"][1])
    check(abs(sq["f_NL_sq"][0] / consistency - 1.0) <= 0.05,
          f"Maldacena: f_NL_sq {sq['f_NL_sq'][0]!r} against (5/12)(1 - n_s) {consistency!r}")
    print(f"curved squeezed_fnl (k_L 22, k_S 14 e-folds before the end) on {card}: "
          f"{sq_s * 1e3:.1f} ms host clock (after an untimed call), B6 launches 2; "
          f"f_NL_sq {sq['f_NL_sq'][0]:.8f} against Maldacena's (5/12)(1 - n_s) "
          f"{consistency:.8f} ({abs(sq['f_NL_sq'][0] / consistency - 1):.2e}; within 5 %); "
          f"δN local f_NL {dn3['f_NL'][1]:.6f}; card vs device='cpu' max_rel={rel_sq:.3e}; "
          f"CPU {sq_cpu_s:.2f} s")
    summary["curved squeezed_fnl"] = {"ms": sq_s * 1e3, "cpu_s": sq_cpu_s,
                                      "max_rel_cpu": rel_sq,
                                      "maldacena_rel": abs(sq["f_NL_sq"][0] / consistency - 1)}
    summary["launches"] = launches
    return sum(launches.values()), summary


# ------------------------------------------------------------------------- #
# phase 30: posterior sampling on the card                                  #
# ------------------------------------------------------------------------- #


def posterior_model():
    """Phase 30's model: examples/posterior.py's two-field quadratic
    (m₁φ₁)² + (m₂φ₂)² on a flat metric."""
    import sympy

    import inflatox_torch

    f1, f2, m1, m2 = sympy.symbols("phi_1 phi_2 m_1 m_2")
    model = inflatox_torch.InflationModelBuilder.new(
        [f1, f2], [[1, 0], [0, 1]], (m1 * f1) ** 2 + (m2 * f2) ** 2, "trivial",
        silent=True).build()
    return inflatox_torch.Compiler(model, silent=True).compile()


def posterior_logps(art, devices):
    """examples/posterior.py's log-posterior (the (n_s, r) pseudo-data at
    the fiducial masses, measured on the CPU, and the Gaussian prior) on
    each of ``devices``."""
    import torch

    from inflatox_torch import inference, observables

    sr = observables.slow_roll(art, device="cpu")(POST_X, POST_THETA)
    data = {"n_s": float(sr["n_s"]), "r": float(sr["r"])}
    logps = {}
    for dev in devices:
        theta = torch.tensor(POST_THETA, dtype=torch.float64, device=dev)

        def prior(th, theta=theta):
            return -0.5 * torch.sum(((th - theta) / POST_PRIOR_SIG) ** 2)

        logps[dev] = inference.observable_log_posterior(art, POST_X, data, POST_SIGMA,
                                                        prior=prior, device=dev)
    return logps


def gaussian_logp(device):
    """The correlated Gaussian of tests/test_inference.py:23-44."""
    import numpy as np
    import torch

    prec = torch.tensor(np.linalg.inv(GAUSS_COV), device=device)
    mean = torch.tensor(GAUSS_MEAN, dtype=torch.float64, device=device)

    def logp(q):
        r = q - mean
        return -0.5 * r @ prec @ r

    return logp


def posterior_kernels(density, chains, d, device, gen):
    """Phase 30's two transitions on ``device``: ``{"hmc": (kernel, draws),
    "nuts": ...}``, each ``draws()`` one block from ``gen``."""
    from inflatox_torch import inference

    return {
        "hmc": (inference._hmc_kernel(density, POST_LEAPFROG),
                lambda: inference._hmc_draws(gen, chains, d, POST_LEAPFROG, device)),
        "nuts": (inference._nuts_kernel(density, NUTS_DEPTH),
                 lambda: inference._nuts_draws(gen, chains, d, NUTS_DEPTH, device)),
    }


def posterior_state(density, device):
    """A start for phase 30's chains near the fiducial masses, the step and
    the posterior's diagonal mass (tests/test_inference.py:92's scales)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(30)
    q = torch.tensor(np.asarray(POST_THETA) + rng.normal(0.0, 0.05, (POST_CHAINS, 2)),
                     device=device)
    lp, g = density(q)
    f64 = dict(dtype=torch.float64, device=device)
    return (q, lp, g), torch.tensor(0.4, **f64), torch.tensor([2.4e-3, 2.4e-3], **f64)


def posterior_trace_worker(out_dir):
    """``--trace-worker DIR posterior``: torch.profiler (CPU and CUDA
    activity) around phase 30's evaluations and transitions on the card;
    prints the launches a density evaluation, an HMC and a NUTS transition
    (the CPU-side ``cudaLaunchKernel`` calls) and the device's idle share
    over the HMC window (the union of the trace's kernel intervals against
    the annotated window's span) as its last line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from inflatox_torch import inference

    device = torch.device("cuda", 0)
    density = inference._Density(posterior_logps(posterior_model(), [device])[device])
    gen = torch.Generator(device=device)
    gen.manual_seed(POST_SEED)
    kernels = posterior_kernels(density, POST_CHAINS, 2, device, gen)
    (q, lp, g), eps, inv_mass = posterior_state(density, device)

    def transitions(name, n):
        """``n`` transitions from the start; the evaluations of each (the
        batch's, the most of its chains'), read after the last."""
        kernel, draws = kernels[name]
        state, used = (q, lp, g), []
        for _ in range(n):
            *state, _, evaluations = kernel(*state, draws(), eps, inv_mass)
            used.append(evaluations.max())
        return int(sum(used))

    def launches(prof):
        return sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)

    transitions("hmc", 2)
    transitions("nuts", 2)
    torch.cuda.synchronize()
    out = {"route": density.route}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(POST_COUNTED):
            density(q)
        torch.cuda.synchronize()
    out["launches_per_evaluation"] = launches(prof) / POST_COUNTED
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        leaves = transitions("nuts", POST_COUNTED)
        torch.cuda.synchronize()
    out["launches_per_nuts_transition"] = launches(prof) / POST_COUNTED
    out["launches_per_nuts_leaf"] = launches(prof) / leaves
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("posterior_hmc"):
            transitions("hmc", POST_COUNTED)
            torch.cuda.synchronize()
    out["launches_per_hmc_transition"] = launches(prof) / POST_COUNTED
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "posterior.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == "posterior_hmc"
              and e.get("cat") == "user_annotation"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel")
    out["kernels_in_trace"] = len(spans)
    if window and spans:
        start, end = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
        busy, last = 0.0, start
        for a, b in spans:
            a, b = max(a, last), min(b, end)
            if b > a:
                busy += b - a
                last = b
        out["idle_share"] = 1.0 - busy / (end - start)
        out["window_ms"] = (end - start) / 1e3
    else:
        out["idle_share"] = None  # no CUDA activity in the trace: not measured
    print(json.dumps(out))
    return 0


def posterior_phase(art, device, card):
    """Phase 30: posterior sampling on the card (see the module docstring);
    returns a summary of its numbers."""
    import numpy as np
    import torch

    from inflatox_torch import inference, observables
    from inflatox_torch.ops import cuda_kernels

    summary = {"card": card}
    before = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    roles = {"card": device, "cpu": torch.device("cpu")}
    logps = posterior_logps(art, roles.values())

    # value and gradient, the card against the CPU
    rng = np.random.default_rng(31)
    worst = 0.0
    for theta in np.asarray(POST_THETA) + rng.normal(0.0, 0.05, (3, 2)):
        got = {}
        for role, dev in roles.items():
            th = torch.tensor(theta, device=dev, requires_grad=True)
            lp = logps[dev](th)
            check(lp.device == th.device and lp.dtype == torch.float64 and lp.shape == (),
                  f"log-posterior on {dev}: {lp.dtype} {tuple(lp.shape)} on {lp.device}")
            got[role] = {"logp": lp.detach(), "grad": torch.autograd.grad(lp, th)[0]}
        worst = max(worst, close_values(got["card"], got["cpu"], RTOL_POSTERIOR))
    summary["logp_max_rel_cpu"] = worst
    print(f"observable_log_posterior at 3 masses on {card}: value and gradient within "
          f"{worst:.3e} of device='cpu' (rtol {RTOL_POSTERIOR})")

    # one HMC and one NUTS transition from the same pre-drawn block
    densities = {role: inference._Density(logps[dev]) for role, dev in roles.items()}
    for name in ("hmc", "nuts"):
        gen = torch.Generator()
        gen.manual_seed(POST_SEED)
        if name == "hmc":
            block = inference._hmc_draws(gen, POST_CHAINS, 2, POST_LEAPFROG, "cpu")
        else:
            block = inference._nuts_draws(gen, POST_CHAINS, 2, NUTS_DEPTH, "cpu")
        outs = {}
        for role, dev in roles.items():
            state, eps, inv_mass = posterior_state(densities[role], dev)
            kernel, _ = posterior_kernels(densities[role], POST_CHAINS, 2, dev, None)[name]
            outs[role] = kernel(*state, tuple(t.to(dev) for t in block), eps, inv_mass)
        card_out, cpu_out = outs["card"], outs["cpu"]
        rel = close_values({k: v for k, v in zip(("q", "logp", "grad", "accept"), card_out)},
                           {k: v for k, v in zip(("q", "logp", "grad", "accept"), cpu_out)},
                           RTOL_POSTERIOR)
        check(torch.equal(card_out[4].cpu(), cpu_out[4]),
              f"{name}: evaluations {card_out[4].tolist()} against {cpu_out[4].tolist()}")
        summary[f"{name}_transition_max_rel_cpu"] = rel
        print(f"one {name.upper()} transition of {POST_CHAINS} chains from one pre-drawn "
              f"block on {card}: within {rel:.3e} of device='cpu'; gradient evaluations a "
              f"chain {card_out[4].tolist()}")

    # ms a transition, the card and the CPU (host clock, median of 3 runs)
    for role, dev in roles.items():
        for name in ("hmc", "nuts"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(POST_SEED)
            kernel, draws = posterior_kernels(densities[role], POST_CHAINS, 2, dev, gen)[name]
            state, eps, inv_mass = posterior_state(densities[role], dev)

            def run(kernel=kernel, draws=draws, state=state, eps=eps, inv_mass=inv_mass):
                s = state
                for _ in range(POST_TIMED):
                    *s, _, _ = kernel(*s, draws(), eps, inv_mass)

            ms = host_clock_ms(run) / POST_TIMED
            summary[f"{name}_ms_per_transition_{role}"] = ms
    print(f"ms a transition of {POST_CHAINS} chains on the posterior (host clock, median of 3 "
          f"runs of {POST_TIMED}; HMC at {POST_LEAPFROG} leapfrog steps, NUTS to depth "
          f"{NUTS_DEPTH}) on {card}: HMC {summary['hmc_ms_per_transition_card']:.2f}, NUTS "
          f"{summary['nuts_ms_per_transition_card']:.2f}; device='cpu' (the card host's CPU): "
          f"HMC {summary['hmc_ms_per_transition_cpu']:.2f}, NUTS "
          f"{summary['nuts_ms_per_transition_cpu']:.2f}")

    # launches an evaluation and a transition, and the idle share, from
    # torch.profiler in a fresh process (the CUPTI activity came back empty
    # late in a long process, PERF.md §7)
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    worker = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-worker",
                             PROFILE_DIR, "posterior"], capture_output=True, text=True,
                            timeout=600)
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    check(worker.returncode == 0, f"posterior trace worker: exit {worker.returncode}: "
          f"{worker.stderr.strip()[-500:]}")
    traced = json.loads(worker.stdout.strip().splitlines()[-1])
    summary.update(traced)
    idle = traced["idle_share"]
    print(f"torch.profiler on {card}, fresh process: {traced['launches_per_evaluation']:.2f} "
          f"launches a density evaluation ({POST_CHAINS} chains), "
          f"{traced['launches_per_hmc_transition']:.1f} an HMC transition, "
          f"{traced['launches_per_nuts_transition']:.1f} a NUTS transition "
          f"({traced['launches_per_nuts_leaf']:.1f} a lockstep leaf); device idle share over "
          f"{POST_COUNTED} HMC transitions under the profiler: "
          + ("not measured (no CUDA activity in the trace)" if idle is None else
             f"{idle:.3f} of {traced['window_ms']:.1f} ms ({traced['kernels_in_trace']} "
             "kernels)"))
    print(f"batching route of the density: {densities['card'].route} (the card), "
          f"{densities['cpu'].route} (device='cpu'); the trace worker's: {traced['route']}")

    # examples/posterior.py's workload on the card, against the Fisher
    # forecast at tests/test_inference.py:92's tolerances
    t = time.perf_counter()
    out = inference.sample_posterior(
        logps[device], POST_THETA, num_samples=POST_SAMPLES, num_warmup=POST_WARMUP,
        num_chains=POST_CHAINS, num_leapfrog=POST_LEAPFROG, seed=POST_SEED, device=device)
    hmc_s = time.perf_counter() - t
    s = out["samples"].reshape(-1, 2)
    fisher = observables.fisher_matrix(art, POST_X, POST_THETA,
                                       np.array([POST_SIGMA["n_s"], POST_SIGMA["r"]]),
                                       device=device)
    var_pred = np.diag(np.linalg.inv(fisher + np.eye(2) / POST_PRIOR_SIG**2))
    var = np.diag(np.cov(s.T))
    se_mean = np.sqrt(var / out["ess"])
    check(np.all(np.isfinite(s)) and s.shape == (POST_CHAINS * POST_SAMPLES, 2),
          f"samples: shape {s.shape}, finite {np.isfinite(s).all()}")
    check(bool(np.all(np.abs(s.mean(0) - POST_THETA) <= 5e-3)),
          f"posterior mean {s.mean(0)} beyond 5e-3 of {POST_THETA}")
    check(bool(np.all(np.abs(var / var_pred - 1) <= 0.15)),
          f"posterior variance {var} against the Fisher forecast {var_pred}: beyond 15 %")
    check(bool(np.all(out["r_hat"] < 1.02)), f"R-hat {out['r_hat']}")
    transitions = POST_WARMUP + POST_SAMPLES
    summary["hmc_workload"] = {
        "s": hmc_s, "ms_per_transition": hmc_s * 1e3 / transitions,
        "warmup": POST_WARMUP, "samples": POST_SAMPLES, "ess": out["ess"].tolist(),
        "r_hat": out["r_hat"].tolist(), "accept": float(out["accept_rate"].mean()),
        "step_size": out["step_size"], "var_ratio": (var / var_pred).tolist(),
        "mean_err": (s.mean(0) - POST_THETA).tolist(), "se_mean": se_mean.tolist()}
    print(f"sample_posterior on {card} (examples/posterior.py's workload: {POST_CHAINS} "
          f"chains, {POST_LEAPFROG} leapfrog steps, {POST_WARMUP} warmup + {POST_SAMPLES} "
          f"draws{POST_CUT}): {hmc_s:.1f} s ({hmc_s * 1e3 / transitions:.2f} ms a transition); "
          f"mean {s.mean(0)} ({np.abs(s.mean(0) - POST_THETA).max():.2e} off, standard error "
          f"{se_mean.max():.2e}, tolerance 5e-3), variance / Fisher forecast "
          f"{var / var_pred} (standard error {np.sqrt(2 / out['ess']).max():.3f}, tolerance "
          f"0.15), ESS {out['ess']}, R-hat {out['r_hat'].max():.4f}, accept "
          f"{out['accept_rate'].mean():.3f}, step {out['step_size']:.4f}")

    # NUTS on the correlated Gaussian (tests/test_inference.py:44's case)
    t = time.perf_counter()
    out = inference.sample_posterior(
        gaussian_logp(device), np.zeros(3), num_samples=NUTS_SAMPLES, num_warmup=NUTS_WARMUP,
        num_chains=4, seed=2, algorithm="nuts", max_tree_depth=NUTS_DEPTH, device=device)
    nuts_s = time.perf_counter() - t
    s = out["samples"].reshape(-1, 3)
    check(bool(np.all(np.abs(s.mean(0) - GAUSS_MEAN) <= 0.08)), f"NUTS mean {s.mean(0)}")
    check(bool(np.all(np.abs(np.cov(s.T) - GAUSS_COV) <= 0.25)), f"NUTS cov {np.cov(s.T)}")
    check(bool(np.all(out["r_hat"] < 1.02) and np.all(out["ess"] > 200)
               and out["accept_rate"].mean() > 0.5),
          f"NUTS R-hat {out['r_hat']}, ESS {out['ess']}, accept {out['accept_rate']}")
    summary["nuts_workload"] = {
        "s": nuts_s, "ms_per_transition": nuts_s * 1e3 / (NUTS_WARMUP + NUTS_SAMPLES),
        "ess": out["ess"].tolist(), "r_hat": out["r_hat"].tolist(),
        "accept": float(out["accept_rate"].mean())}
    print(f"NUTS on the correlated Gaussian on {card} (4 chains, {NUTS_WARMUP} warmup + "
          f"{NUTS_SAMPLES} draws, cut from the test's 600 + 1500, depth {NUTS_DEPTH}): "
          f"{nuts_s:.1f} s "
          f"({nuts_s * 1e3 / (NUTS_WARMUP + NUTS_SAMPLES):.2f} ms a transition); mean off by "
          f"{np.abs(s.mean(0) - GAUSS_MEAN).max():.3f} (0.08), covariance by "
          f"{np.abs(np.cov(s.T) - GAUSS_COV).max():.3f} (0.25), ESS {out['ess']}, R-hat "
          f"{out['r_hat'].max():.4f}, accept {out['accept_rate'].mean():.3f}")

    after = dict(cuda_kernels.LAUNCHES_BY_KERNEL)
    check(after == before, f"phase 30 launched a kernel of B1-B8: {before} -> {after}")
    return summary


# ------------------------------------------------------------------------- #
# phase 31: many devices on the card                                        #
# ------------------------------------------------------------------------- #


def same_bits(got, want, label):
    """Fails unless two results (tensors or numpy arrays) have one shape, one
    dtype and the same bytes (NaN and ±inf masks included)."""
    import numpy as np

    def host(v):
        return np.ascontiguousarray(v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))

    got, want = host(got), host(want)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {got.shape} {got.dtype} against {want.shape} {want.dtype}")
    check(bool(np.array_equal(got.view(np.uint8), want.view(np.uint8))),
          f"{label}: not bit for bit the unsharded call")


def mesh_counted(label, fn, kernel, expected, also=None):
    """``fn()`` with every launch count set to 0 before and read after:
    fails unless ``kernel`` (a B1-B7 name, "B6", or None for none) was
    launched ``expected`` times, the kernels of ``also`` (name → launches)
    as it says, and no other kernel at all."""
    import torch

    from inflatox_torch.ops import cuda_kernels

    reset_counts()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in cuda_kernels.LAUNCHES_BY_KERNEL.items() if v}
    want = {**({kernel: expected} if kernel else {}), **(also or {})}
    check(counts == want, f"phase 31 {label}: launches {counts}, expected {want}")
    return out


def mesh_phase(art, args, al, egno, egno_args, quad, post_art, rkf, pts, device, card):
    """Phase 31: the port's meshes on the card (module docstring); returns
    the phase's summary."""
    import numpy as np
    import torch

    from inflatox_torch import background, inference
    from inflatox_torch import perturbations as pert
    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.ops.cuda_kernels import PRECISIONS, scan_cuda, scan_points_cuda
    from inflatox_torch.ops.cuda_solver import solve_cuda
    from inflatox_torch.parallel import (
        make_mesh,
        parameter_sweep,
        sharded_scan,
        sharded_scan_ot,
        sharded_solve_eom_batch,
    )

    card_mesh = make_mesh()  # (a): the card, one slot
    check(card_mesh.size == torch.cuda.device_count() == 1,
          f"make_mesh() has {card_mesh.size} slots on {torch.cuda.device_count()} card(s)")
    four = make_mesh(("grid",), devices=[device] * MESH_SLOTS)  # (b): four slots on cuda:0
    meshes = {"a": card_mesh, "b": four}
    summary = {"card": card, "launches": {}, "ms": {}}

    def record(name, sharded_ms, single_ms, launches):
        summary["ms"][name] = {"sharded": sharded_ms, "unsharded": single_ms}
        summary["launches"][name] = launches

    # grid scans: cfg1 in f64 (B1) and f32 (B2), EGNO at 2048² in
    # double-double (B4); kernel paths timed with CUDA events, in turns
    egno_al = GeneralisedAL(egno, device=device, validate_basis=False)
    for label, cond, a, p, extent, n, precision in (
            ("cfg1 f64", al, art, args, DOC_EXTENT, MESH_CFG1_N, "f64"),
            ("cfg1 f32", al, art, args, DOC_EXTENT, MESH_CFG1_N, "f32"),
            ("EGNO dd", egno_al, egno, egno_args, EGNO_EXTENT, MESH_EGNO_N, "dd")):
        kernel = PRECISIONS[precision].grid_kernel
        single = scan_cuda(a, "complete_analysis", p, extent, (n, n), device, precision)
        for m, mesh in meshes.items():
            slots = mesh.shape["grid"]

            def sharded(mesh=mesh):
                return sharded_scan(cond, p, extent, (n, n), mesh, precision=precision)

            name = f"sharded_scan {label} {n}² mesh ({m})"
            got = mesh_counted(name, sharded, kernel, slots)
            same_bits(got, single, name)
            if label == "cfg1 f64" and m == "b":
                rows = min(64, n)
                rel, _, _ = compare(got[:, :rows].cpu(), cpu_band(a, "complete_analysis", p,
                                                                  extent, (n, n), rows))
                print(f"{name}: rows 0-{rows - 1} vs plain torch on the CPU max_rel={rel:.3e} "
                      f"(rtol {RTOL})")
            ms, single_ms, windows = in_turns(
                sharded, lambda: scan_cuda(a, "complete_analysis", p, extent, (n, n), device,
                                           precision), N_TIMED, N_TIMED)
            record(name, ms, single_ms, {kernel: slots})
            print(f"{name} on {card}: {slots} {kernel} launch(es), bit for bit the unsharded "
                  f"scan; {ms:.4f} ms a call against {single_ms:.4f} unsharded (CUDA events, "
                  f"{N_TIMED} chained calls, in turns: {', '.join(f'{w:.4f}' for w in windows)})")
        del single
    with_six = False
    try:
        sharded_scan(al, args, DOC_EXTENT, (6, MESH_CFG1_N), four)
    except ValueError as exc:
        with_six = "divisible" in str(exc)
    check(with_six, "a 6-row grid over four slots did not raise")
    # the user-facing call: maps to the host (pinned per shard) against
    # complete_analysis(output="f64")
    n = MESH_CFG1_N
    for m, mesh in meshes.items():
        name = f"sharded_scan cfg1 output='f64' mesh ({m})"
        got = mesh_counted(name, lambda mesh=mesh: sharded_scan(al, args, DOC_EXTENT, (n, n),
                                                                mesh, output="f64"),
                           "B1", mesh.shape["grid"])
        same_bits(got, np.stack(al.complete_analysis(args, *DOC_EXTENT, n, n, progress=False)),
                  name)
        ms = host_clock_ms(lambda mesh=mesh: sharded_scan(al, args, DOC_EXTENT, (n, n), mesh,
                                                          output="f64"))
        single_ms = host_clock_ms(lambda: al.complete_analysis(args, *DOC_EXTENT, n, n,
                                                               progress=False))
        record(name, ms, single_ms, {"B1": mesh.shape["grid"]})
        print(f"{name} on {card}: {ms:.1f} ms against complete_analysis(output='f64') "
              f"{single_ms:.1f} ms (host clock, median of 3)")
    del got

    # B5a over phase 8's 8.19 M solved points
    single = scan_points_cuda(art, "complete_analysis", args, pts)
    for m, mesh in meshes.items():
        slots = mesh.shape["grid"]
        name = f"sharded_scan_ot {pts.shape[0]} points mesh ({m})"
        got = mesh_counted(name, lambda mesh=mesh: sharded_scan_ot(al, args, pts, mesh),
                           "B5a", slots)
        same_bits(got, single, name)
        ms, single_ms, _ = in_turns(lambda mesh=mesh: sharded_scan_ot(al, args, pts, mesh),
                                    lambda: scan_points_cuda(art, "complete_analysis", args, pts),
                                    N_TIMED, N_TIMED)
        record(name, ms, single_ms, {"B5a": slots})
        print(f"{name} on {card}: {slots} B5a launch(es), bit for bit; {ms:.4f} ms against "
              f"{single_ms:.4f} unsharded (CUDA events, {N_TIMED} chained calls, in turns)")
    del single, got

    # B6 at cfg5d: 4096 × 2000 RKF45, shared and per-trajectory masses; mesh
    # (b) takes 4093 trajectories (not a multiple of 4: the padding path)
    pt, steps, ft, dt, max_err, _ = rkf["args"]
    f0 = ft.cpu().numpy()
    masses = np.linspace(0.5, 2.0, B_SOLVE)[:, None]
    mt = torch.tensor(masses, device=device)
    for m, mesh in meshes.items():
        axis = mesh.axis_names[0]
        slots = mesh.shape[axis]
        b = B_SOLVE if m == "a" else MESH_SOLVE_B
        for pars, ptens, what in ((args, pt, "shared"), (masses[:b], mt[:b], "per-trajectory")):
            name = f"sharded_solve_eom_batch cfg5d {b}x{steps} {what} mesh ({m})"
            single = solve_cuda(art, ptens, steps, ft[:b], dt[:b], max_err, "rkf")
            rows, times = mesh_counted(name, lambda mesh=mesh, pars=pars: (
                sharded_solve_eom_batch(art, pars, steps, f0[:b], f0[:b] * 0.0, mesh,
                                        solve_axis=axis, max_err=max_err, return_time=True)),
                "B6", slots)
            same_bits(rows, single[0], name)
            same_bits(times, single[1], name + " (times)")
            if what == "shared" and m == "b":  # against phase 8's CPU rows
                k = min(b, rkf["cpu"][0].shape[0])
                cpu_rows_check(torch.from_numpy(rows[:k]), torch.from_numpy(times[:k]),
                               rkf["cpu"][0][:k], rkf["cpu"][1][:k], art.n_fields, name)

            def kernel_path(mesh=mesh, pars=pars):
                sharded_solve_eom_batch(art, pars, steps, f0[:b], f0[:b] * 0.0, mesh,
                                        solve_axis=axis, max_err=max_err, combine="device")

            ms, single_ms, _ = in_turns(kernel_path, lambda ptens=ptens: solve_cuda(
                art, ptens, steps, ft[:b], dt[:b], max_err, "rkf"), MESH_SOLVE_TIMED,
                MESH_SOLVE_TIMED)
            host_ms = host_clock_ms(lambda mesh=mesh, pars=pars: background.solve_eom_batch(
                art, pars, steps, f0[:b], f0[:b] * 0.0, max_err=max_err, solver="rkf",
                mesh=mesh, device=device))
            single_host = host_clock_ms(lambda pars=pars: background.solve_eom_batch(
                art, pars, steps, f0[:b], f0[:b] * 0.0, max_err=max_err, solver="rkf",
                device=device))
            record(name, ms, single_ms, {"B6": slots})
            summary["ms"][name].update({"host_sharded": host_ms, "host_unsharded": single_host})
            print(f"{name} on {card}: {slots} B6 launch(es), rows and times bit for bit; "
                  f"combine='device' {ms:.4f} ms against {single_ms:.4f} unsharded (CUDA "
                  f"events, {MESH_SOLVE_TIMED} chained calls, in turns); "
                  f"background.solve_eom_batch(mesh=) {host_ms:.1f} ms against "
                  f"{single_host:.1f} ms (host clock, median of 3)")
    del single, rows, times

    # B7a at cfg5 (32 × 512²); mesh (b) 31 sets
    for m, mesh in meshes.items():
        axis = mesh.axis_names[0]
        slots = mesh.shape[axis]
        sets = SWEEP_SETS if m == "a" else MESH_SWEEP_SETS
        batch = np.linspace(0.5, 2.0, SWEEP_SETS)[:sets, None]
        name = f"parameter_sweep cfg5 {sets}x{SWEEP_N}² mesh ({m})"

        def sweep(mesh=mesh, batch=batch, axis=axis):
            return parameter_sweep(al, batch, DOC_EXTENT, (SWEEP_N, SWEEP_N), mesh=mesh,
                                   sweep_axis=axis, progress=False)

        got = mesh_counted(name, sweep, "B7a", slots)
        same_bits(got, parameter_sweep(al, batch, DOC_EXTENT, (SWEEP_N, SWEEP_N),
                                       progress=False), name)
        ms = host_clock_ms(sweep)
        single_ms = host_clock_ms(lambda batch=batch: parameter_sweep(
            al, batch, DOC_EXTENT, (SWEEP_N, SWEEP_N), progress=False))
        record(name, ms, single_ms, {"B7a": slots})
        print(f"{name} on {card}: {slots} B7a launch(es), bit for bit; {ms:.1f} ms against "
              f"{single_ms:.1f} ms unsharded (host clock, median of 3)")
    del got

    # the survey at cfg5e (phase 10's starts); mesh (b) 4093 of them
    f0s = np.random.default_rng(1).uniform(1.5, 2.5, (2, B_SOLVE)).T.copy()
    for m, mesh in meshes.items():
        slots = mesh.shape[mesh.axis_names[0]]
        b = B_SOLVE if m == "a" else MESH_SOLVE_B
        name = f"survey_initial_conditions cfg5e {b}x{STEPS} mesh ({m})"

        def survey(mesh=mesh, b=b):
            return background.survey_initial_conditions(art, args, STEPS, f0s[:b], np.zeros(2),
                                                        max_err=1e-6, chunk=B_SOLVE, mesh=mesh,
                                                        device=device)

        got = mesh_counted(name, survey, "B6", slots, also={"B9": 1})  # B9 on mesh.home
        want = background.survey_initial_conditions(art, args, STEPS, f0s[:b], np.zeros(2),
                                                    max_err=1e-6, chunk=B_SOLVE, device=device)
        for key in want:
            same_bits(got[key], want[key], f"{name} {key}")
        ms = host_clock_ms(survey)
        single_ms = host_clock_ms(lambda b=b: background.survey_initial_conditions(
            art, args, STEPS, f0s[:b], np.zeros(2), max_err=1e-6, chunk=B_SOLVE, device=device))
        record(name, ms, single_ms, {"B6": slots, "B9": 1})
        print(f"{name} on {card}: {slots} B6 launch(es) and one B9, all five outputs bit for bit; "
              f"{ms:.1f} ms against {single_ms:.1f} ms unsharded (host clock, median of 3)")

    # the spectra: phase 29's quadratic model, one set, 8 pivots, a 2-slot
    # mesh; δN's solve split over it, the RK4 loops' pivots split (rtol 1e-12)
    two = make_mesh(("grid",), devices=[device] * SPECTRA_MESH_SLOTS)
    m_args = np.array([1.0, 1.0])
    rows, times = background.solve_eom(quad, m_args, SPECTRA_KW["steps"], [12.0, 0.0],
                                       [0.0, 0.0], max_err=1e-8, solver="rkf",
                                       return_time=True, device=device)
    dn_kw = {k: SPECTRA_KW[k] for k in ("pivots", "N_margin_start", "N_margin_end", "steps")}
    loop_kw = dict(pivots=SPECTRA_KW["pivots"], N_margin_start=SPECTRA_KW["N_margin_start"],
                   N_margin_end=SPECTRA_KW["N_margin_end"], **MESH_SPECTRA_STEPS)
    for route, fn, kw, kernel, launches in (
            ("delta_n_spectrum", pert.delta_n_spectrum, dn_kw, "B6", SPECTRA_MESH_SLOTS),
            ("mode_spectrum", pert.mode_spectrum, loop_kw, None, 0),
            ("transport_spectrum", pert.transport_spectrum, loop_kw, None, 0)):
        name = f"{route} quadratic 8 pivots, 2-slot mesh"
        t = time.perf_counter()
        got = mesh_counted(name, lambda fn=fn, kw=kw: fn(quad, m_args, rows, times, mesh=two,
                                                         device=device, **kw), kernel, launches)
        ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = fn(quad, m_args, rows, times, device=device, **kw)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t) * 1e3
        floors = {k: FLOOR_SPECTRA for k in ("cos_delta", "T_RS")}
        rel = max(close_values(got[k], want[k], RTOL_MESH_SPECTRA, floors.get(k, 0.0))
                  for k in want)
        record(name, ms, single_ms, {kernel: launches} if kernel else {})
        summary["ms"][name]["max_rel"] = rel
        print(f"{name} on {card}: {ms:.1f} ms against {single_ms:.1f} ms unsharded (host "
              f"clock, one call each); B6 launches {launches if kernel else 0}; sharded vs "
              f"unsharded max_rel={rel:.3e} (rtol {RTOL_MESH_SPECTRA})")

    # the posterior: phase 30's model, 4 chains over a 2-slot mesh
    logp = posterior_logps(post_art, [device])[device]
    post_kw = dict(num_samples=MESH_POST_SAMPLES, num_warmup=MESH_POST_WARMUP,
                   num_chains=POST_CHAINS, num_leapfrog=POST_LEAPFROG, seed=POST_SEED,
                   device=device)
    name = f"sample_posterior {POST_CHAINS} chains, 2-slot mesh"
    t = time.perf_counter()
    got = mesh_counted(name, lambda: inference.sample_posterior(logp, POST_THETA, mesh=two,
                                                                **post_kw), None, 0)
    ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    want = inference.sample_posterior(logp, POST_THETA, **post_kw)
    single_ms = (time.perf_counter() - t) * 1e3
    for key in ("samples", "log_prob", "accept_rate", "inv_mass"):
        same_bits(got[key], want[key], f"{name} {key}")
    check(got["step_size"] == want["step_size"], f"{name}: step sizes differ")
    record(name, ms, single_ms, {})
    print(f"{name} on {card}: {MESH_POST_WARMUP} + {MESH_POST_SAMPLES} HMC transitions in "
          f"{ms:.0f} ms against {single_ms:.0f} ms unsharded (host clock, one call each); the "
          f"draws bit for bit; no kernel launched")

    # (c): two processes sharing cuda:0 (gloo), each rank's gathered result
    # bit for bit its single-device call
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker",
                               f"localhost:{port}", str(rank)], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"OK process {rank}" in out,
              f"--dist-worker {rank} failed (exit {p.returncode}):\n{out[-4000:]}")
        result = json.loads(out.strip().splitlines()[-1])
        summary[f"process {rank}"] = result
        print(f"two processes on {card}, rank {rank}: " + json.dumps(result))
    return summary


def dist_worker(argv):
    """``--dist-worker ADDRESS RANK``: one of phase 31's two processes on
    cuda:0, joined by ``distributed.initialize`` (gloo): cfg1's sharded scan
    and cfg5d's sharded solve over a 2-slot mesh (one slot a process),
    each gathered result bit for bit this process's single-device call;
    prints ``OK process RANK`` and a JSON line of times (host clock)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import inflatox_torch
    from inflatox_torch import background
    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.parallel import distributed, make_mesh, sharded_scan

    address, rank = argv[0], int(argv[1])
    distributed.initialize(coordinator_address=address, num_processes=2, process_id=rank)
    check(distributed.is_multi_host(), "the process group did not start")
    device = torch.device("cuda", 0)
    model, args = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    al = GeneralisedAL(art, device=device, validate_basis=False)
    grid = make_mesh(("grid",), devices=[device])
    check(grid.size == 2 and grid.multi_process, f"mesh {grid}")
    n = MESH_CFG1_N

    def scan():
        return sharded_scan(al, args, DOC_EXTENT, (n, n), grid, output="f64")

    maps = mesh_counted("two processes: sharded_scan", scan, "B1", 1)  # this rank's slot
    single = np.stack(al.complete_analysis(args, *DOC_EXTENT, n, n, progress=False))
    same_bits(maps, single, f"rank {rank}: sharded_scan cfg1")
    f0 = np.random.default_rng(0).uniform(1.5, 2.5, (2, B_SOLVE)).T.copy()

    def solve():
        return background.solve_eom_batch(art, args, STEPS, f0, f0 * 0.0, solver="rkf",
                                          return_time=True, mesh=grid, device=device)

    rows, times = mesh_counted("two processes: solve_eom_batch", solve, "B6", 1)
    want = background.solve_eom_batch(art, args, STEPS, f0, f0 * 0.0, solver="rkf",
                                      return_time=True, device=device)
    same_bits(rows, want[0], f"rank {rank}: solve rows")
    same_bits(times, want[1], f"rank {rank}: solve times")
    result = {
        "rank": rank,
        "scan_ms": host_clock_ms(scan),
        "scan_unsharded_ms": host_clock_ms(lambda: al.complete_analysis(
            args, *DOC_EXTENT, n, n, progress=False)),
        "solve_ms": host_clock_ms(solve),
        "solve_unsharded_ms": host_clock_ms(lambda: background.solve_eom_batch(
            art, args, STEPS, f0, f0 * 0.0, solver="rkf", return_time=True, device=device)),
        "bit_identical": True,
    }
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"OK process {rank}")
    print(json.dumps(result), flush=True)
    return 0


# ------------------------------------------------------------------------- #
# phase 32: the examples on the card, and the C oracle on the card's host   #
# ------------------------------------------------------------------------- #


def examples_phase(modules, art, args, device, card):
    """Phase 32 (module docstring): every example at its full sizes on the
    card through ``main(["--device", "cuda"])``, each launching the kernels
    ``scripts/time_examples.py`` names for it; then the port's C oracle
    (``inflatox_torch.native``) at cfg1 against kernel B1.  Returns the
    phase's summary."""
    import numpy as np
    import torch

    import time_examples
    from inflatox_torch.native import NativeModel, native_available
    from inflatox_torch.ops.cuda_kernels import scan_cuda

    summary = {"examples": {}}
    for name, kernels in time_examples.EXAMPLES.items():
        try:
            result = time_examples.run(name, modules[name], "cuda")
        except AssertionError as e:
            raise SmokeFailure(f"phase 32 {name}: the example's own check failed: {e}") from e
        for kernel in kernels:
            launched(kernel, f"phase 32 {name}")
        out = result["out"]
        if name == "quickstart":
            check(abs(out["V"] - GOLDEN_V) <= 1e-12 * GOLDEN_V, f"quickstart: V = {out['V']!r}")
            check(out["fast_ran"] == "kernel B1", f"quickstart: the f64 route ran {out['fast_ran']}")
        elif name == "engines_tour":
            rows = out["rows"]
            check(rows["f64"]["median_dev"] == 0.0 and rows["dd"]["median_dev"] < 1e-14
                  and rows["f32"]["median_dev"] < RTOL_F32,
                  f"engines_tour: median deviations {[r['median_dev'] for r in rows.values()]}")
        elif name == "special_functions":
            check("B8" in out["bessel_route"] and "B8" in out["hyp_route"]
                  and out["finite_fraction"] > 0 and out["V_grid_finite"],
                  f"special_functions: {out['bessel_route']}, {out['hyp_route']}")
        summary["examples"][name] = {"wall_s": result["wall_s"], "launches": result["launches"]}
        print(f"phase 32 {name} on {card}: wall {result['wall_s']:.3f} s (host clock, one call "
              f"at the script's full sizes, its kernel libraries built in phase 2); kernel "
              f"launches {result['launches']}; its last line: {result['last_line']}", flush=True)

    # the C oracle at cfg1 against kernel B1
    check(native_available(), "phase 32: no C compiler on the card's host for the C oracle")
    t = time.perf_counter()
    nm = NativeModel(art.model)
    build_s = time.perf_counter() - t
    n = 4096
    fused_s = host_clock_ms(lambda: nm.complete_analysis(args, *DOC_EXTENT, n, n)) / 1e3
    ref_s = host_clock_ms(lambda: nm.complete_analysis_refstyle(args, *DOC_EXTENT, n, n)) / 1e3
    b1_ms = time_ms(lambda: scan_cuda(art, "complete_analysis", args, DOC_EXTENT, (n, n), device),
                    N_TIMED_KERNEL)
    rates = {"c_fused": n * n / fused_s, "c_refstyle": n * n / ref_s, "b1": n * n / b1_ms * 1e3}
    compiler = run([nm.cc, "--version"]).splitlines()[0]
    print(f"phase 32 C oracle (inflatox_torch.native: {nm.cc}, {compiler}; -O3 -march=native "
          f"-fopenmp) on the card's host ({os.cpu_count()} cores), cfg1 {n}²: build "
          f"{build_s:.2f} s; fused "
          f"{fused_s:.4f} s ({rates['c_fused']:.4e} points/s), refstyle {ref_s:.4f} s "
          f"({rates['c_refstyle']:.4e} points/s), median of 3; kernel B1 on {card} "
          f"{b1_ms:.4f} ms ({rates['b1']:.4e} points/s, CUDA events over {N_TIMED_KERNEL} "
          f"chained launches): B1 / fused {rates['b1'] / rates['c_fused']:.1f}x, B1 / refstyle "
          f"{rates['b1'] / rates['c_refstyle']:.1f}x", flush=True)
    oracle = torch.from_numpy(np.stack(nm.complete_analysis(args, *DOC_EXTENT, n, n))).to(device)
    maps = scan_cuda(art, "complete_analysis", args, DOC_EXTENT, (n, n), device)
    rows = 64
    rel64, abs64, same64 = compare(maps[:, :rows], oracle[:, :rows])
    # the whole map: identical masks, and every value within RTOL except
    # where the map is not settled to RTOL by its inputs' last bit: where
    # moving the extent's ends one ulp up (each coordinate by about one ulp)
    # moves B1's own value by more than RTOL / 10 (there V's two terms
    # cancel, e.g. ε_V ~ 4e15; two correct f64 evaluations part there)
    t = time.perf_counter()
    rel, absolute, same = compare(maps, oracle, rtol=float("inf"))
    nudged = scan_cuda(art, "complete_analysis", args,
                       tuple(float(np.nextafter(e, np.inf)) for e in DOC_EXTENT), (n, n), device)
    finite = torch.isfinite(oracle)
    unsettled = finite & ~((nudged - maps).abs() <= RTOL / 10 * maps.abs())
    beyond = finite & ((maps - oracle).abs() > RTOL * oracle.abs())
    n_unsettled, n_beyond = int(unsettled.sum()), int(beyond.sum())
    n_finite = int(finite.sum())
    whole_s = time.perf_counter() - t
    check(not bool((beyond & ~unsettled).any()),
          f"phase 32: B1 against the C oracle beyond rtol {RTOL} at "
          f"{int((beyond & ~unsettled).sum())} settled values")
    check(n_unsettled <= 1e-4 * n_finite,
          f"phase 32: {n_unsettled} of {n_finite} finite values unsettled by one ulp")
    print(f"phase 32 kernel B1 against the C oracle at cfg1, identical NaN/±inf masks, rtol "
          f"{RTOL}: rows 0-{rows - 1} max_rel={rel64:.3e} max_abs={abs64:.3e} "
          f"bit_identical={same64:.6f}; the whole map ({n_finite} finite values) "
          f"max_rel={rel:.3e} max_abs={absolute:.3e} bit_identical={same:.6f}, {n_beyond} "
          f"beyond rtol {RTOL}, each among the {n_unsettled} values that a one-ulp move of "
          f"the extent moves by more than {RTOL / 10:.0e} ({whole_s:.2f} s on the card)",
          flush=True)
    summary["c_oracle"] = {"cores": os.cpu_count(), "compiler": compiler, "points_per_s": rates,
                           "b1_ms": b1_ms, "fused_s": fused_s, "refstyle_s": ref_s,
                           "max_rel": rel, "bit_identical": same, "beyond_rtol": n_beyond,
                           "unsettled": n_unsettled, "finite": n_finite}
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import sympy

    import inflatox_torch
    from inflatox_torch import background
    from inflatox_torch.consistency_conditions import GeneralisedAL
    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.build import (
        find_nvcc,
        load_grid_scan,
        load_solver,
        load_special_eval,
    )
    from inflatox_torch.ops.cuda_kernels import (
        scan_cuda,
        scan_points_cuda,
        scan_points_torch,
        scan_torch,
    )
    from inflatox_torch.ops.cuda_solver import solve_cuda

    t_start = time.perf_counter()

    # 1. environment
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0] if card else "unknown"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print("nvcc: " + run([find_nvcc(), "--version"]).splitlines()[-1])
    print(f"sympy {sympy.__version__}")
    print(f"card: {card} (torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))")
    device = torch.device("cuda", 0)

    # 2. build: models, lowering, then every kernel library at once
    t0 = time.perf_counter()
    model, args = inflatox_torch.models.hyperinflation()
    art = inflatox_torch.Compiler(model, silent=True).compile()
    t1 = time.perf_counter()
    ang_model, ang_args = inflatox_torch.models.angular()
    ang = inflatox_torch.Compiler(ang_model, silent=True).compile()
    a3, b3, c3, m3 = sympy.symbols("a3 b3 c3 m3")
    three_model = inflatox_torch.InflationModelBuilder.new(
        [a3, b3, c3], [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        sympy.Rational(1, 2) * m3**2 * (a3**2 + 2 * b3**2 + 3 * c3**2), silent=True,
    ).build(guesses=[[0, 1, 0], [0, 0, 1]])
    three = inflatox_torch.Compiler(three_model, silent=True).compile()
    t2 = time.perf_counter()
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
    egno = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "egno_bundle.json"))
    egno_args = inflatox_torch.models._args_by_symbol(egno.model, EGNO_ARGS)
    d5 = inflatox_torch.CompiledModel.load(os.path.join(fixtures, "d5_bundle.json"))
    d5_args = inflatox_torch.models._args_by_symbol(d5.model, D5_ARGS)
    t_bundles = time.perf_counter() - t2
    t2 = time.perf_counter()
    special = special_models()  # phases 22-27
    t_special = time.perf_counter() - t2
    t2 = time.perf_counter()
    aa, aa_args, hyperbolic = cmb_models()  # phase 28
    t_cmb_models = time.perf_counter() - t2
    t2 = time.perf_counter()
    quad, curved, c_args = spectra_models()  # phase 29
    t_spectra_models = time.perf_counter() - t2
    t2 = time.perf_counter()
    post_art = posterior_model()  # phase 30
    t_post_model = time.perf_counter() - t2
    t2 = time.perf_counter()

    def timed(load, source):
        t = time.perf_counter()
        lib = load(source)
        return lib, time.perf_counter() - t

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import probe_solver_chain as chain  # B6's attribution (phase 11)
    import time_examples  # phase 32

    t2 = time.perf_counter()
    example_modules = {name: time_examples.load(name) for name in time_examples.EXAMPLES}
    example_jobs = {f"example {label}": (load, source)
                    for name, module in example_modules.items()
                    for label, load, source in time_examples.libraries(name, module)}
    t_example_models = time.perf_counter() - t2
    t2 = time.perf_counter()

    parent = sys.argv[2] if sys.argv[1:2] == ["--parent"] else None
    parent_jobs = start_parent_builds(os.path.abspath(parent)) if parent else {}

    jobs = {
        "B1/B5 hyperinflation": (load_grid_scan, art.cuda_source()),
        "B6 hyperinflation": (load_solver, art.cuda_solver_source()),
        "B1/B5 angular": (load_grid_scan, ang.cuda_source()),
        "B6 3-field": (load_solver, three.cuda_solver_source()),
        "B2 hyperinflation": (load_grid_scan, art.cuda_source("f32")),
        "B1/B5a D5": (load_grid_scan, d5.cuda_source("f64")),
        "B4/B5b EGNO": (load_grid_scan, egno.cuda_source("dd")),
        "B6 hyperinflation, instrumented": (chain.load_parts, art.cuda_solver_source()),
        "B8 alone": (lambda _: load_special_eval(), None),
        "B1/B5a S1": (load_grid_scan, special["S1"].cuda_source()),
        "B2 S1": (load_grid_scan, special["S1"].cuda_source("f32")),
        "B1/B5a S2": (load_grid_scan, special["S2"].cuda_source()),
        "B2 S2": (load_grid_scan, special["S2"].cuda_source("f32")),
        "B1/B5a S3": (load_grid_scan, special["S3"].cuda_source()),
        "B2 S3": (load_grid_scan, special["S3"].cuda_source("f32")),
        "B6 S2": (load_solver, special["S2"].cuda_solver_source()),
        "B6 α-attractor": (load_solver, aa.cuda_solver_source()),
        "B6 quadratic": (load_solver, quad.cuda_solver_source()),
        "B6 curved": (load_solver, curved.cuda_solver_source()),
        "B6 S2, instrumented": (lambda source: chain.load_parts(source, "smoke_s2"),
                                special["S2"].cuda_solver_source()),
        **{f"{b} {name}": (load_grid_scan, special[name].cuda_source(precision))
           for name in ("C9", "sinc") for b, precision in (("B1", "f64"), ("B2", "f32"),
                                                           ("B4", "dd"))},
        **example_jobs,  # phase 32
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(timed, *job) for name, job in jobs.items()}
        built = {name: f.result() for name, f in futures.items()}
    t3 = time.perf_counter()
    al = GeneralisedAL(art, device=device, validation_seed=7)
    print(f"build: hyperinflation model {t1 - t0:.2f} s, angular and 3-field models "
          f"{t2 - t1 - t_bundles - t_special - t_example_models:.2f} s, EGNO and D5 from "
          f"their bundles "
          f"{t_bundles:.2f} s, the special-function models S1-S3, C9 and sinc "
          f"{t_special:.2f} s; "
          f"kernel B1 first use (nvcc + load) {built['B1/B5 hyperinflation'][1]:.2f} s; all "
          f"{len(jobs)} kernel libraries, built at once, {t3 - t2:.2f} s; nvcc per library: "
          + ", ".join(f"{name} {lib.build_seconds:.2f} s" for name, (lib, _) in built.items()))
    print(f"build: the examples' models (phase 32) {t_example_models:.2f} s; their "
          f"{len(example_jobs)} libraries among the {len(jobs)}")
    for name in jobs:
        if name.startswith(("B6", "example")):
            continue  # phase 7; the examples' libraries are instances of the others
        log = open(built[name][0].build_log).read()
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
        spills = [int(a) + int(b) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        stack = [int(v) for v in re.findall(r"(\d+) bytes stack frame", log)]
        points = point_instances(log)
        print(f"ptxas, {name}: {len(regs)} functions, registers {min(regs)}-{max(regs)}, "
              f"spill bytes (stores + loads) at most {max(spills)}, stack frame at most "
              f"{max(stack)} bytes" + ("; point-scan instances (registers, spill bytes): "
                                       + ", ".join(f"{k} {r}, {b}" for k, (r, b) in points.items())
                                       if points else ""))

    # 3. golden values
    v = al.calc_V([2.0, -2.0], [1.0])
    h = al.calc_H([2.0, -2.0], [1.0])
    check(abs(v - GOLDEN_V) <= 1e-12 * GOLDEN_V, f"calc_V = {v!r}")
    check(all(abs(h[a][b] - GOLDEN_H[a][b]) <= 1e-8 + 1e-5 * abs(GOLDEN_H[a][b])
              for a in range(2) for b in range(2)), f"calc_H = {h.tolist()}")
    print(f"golden: calc_V([2,-2],[1]) = {v!r}, calc_H = {h.tolist()}")

    # 4. the grid-scan path at the bench size, then at the README's
    _, b1_launches, b1_max_abs = scan_and_check(al, art, args, DOC_EXTENT, 4096,
                                                "hyperinflation 4096²")
    scan_and_check(al, art, args, README_EXTENT, 1000, "hyperinflation 1000² (README)")

    # 5. a second model
    ang_al = GeneralisedAL(ang, device=device, validate_basis=False)
    ang_al.validate_basis_on_domain(ang_args, [-0.7, -0.7], [0.7, 0.7], N=63)
    scan_and_check(ang_al, ang, ang_args, ANGULAR_EXTENT, 1024, "angular 1024²")

    # 6. timing at 4096², in turns: plain, kernel, kernel, plain
    n = 4096

    def kernel():
        scan_cuda(art, "complete_analysis", args, DOC_EXTENT, (n, n), device)

    def plain():
        scan_torch(art, "complete_analysis", args, DOC_EXTENT, (n, n), device)

    b1_ms, b1_plain_ms, (kernel_a, kernel_b, plain_a, plain_b) = in_turns(
        kernel, plain, N_TIMED_KERNEL, N_TIMED)
    print(f"timing hyperinflation complete_analysis {n}² f64 on {card}: "
          f"kernel B1 {b1_ms:.4f} ms/launch ({n * n / b1_ms * 1e3:.4e} points/s; "
          f"windows {kernel_a:.4f}, {kernel_b:.4f}; {N_TIMED_KERNEL} chained "
          f"launches each), plain torch {b1_plain_ms:.4f} ms "
          f"({n * n / b1_plain_ms * 1e3:.4e} points/s; windows {plain_a:.4f}, "
          f"{plain_b:.4f}; {N_TIMED} chained calls each)")
    b1_bound = bound(6 * n * n * 8, point_ops(art) * n * n)
    print(f"kernel B1 bound at {n}²: {b1_bound[0]:.4f} ms ({b1_bound[1]}; "
          f"{6 * n * n * 8} bytes written, {point_ops(art)} f64 operations per point)")

    # the kernel's own device time, from the profiler's trace, and the
    # wrapper's host time per call (enqueue only)
    traced = profiled_ms(kernel, "grid_scan_kernel", N_TIMED)
    t = time.perf_counter()
    for _ in range(N_TIMED):
        kernel()
    enqueue_ms = (time.perf_counter() - t) * 1e3 / N_TIMED
    torch.cuda.synchronize()
    print(f"kernel B1 device time per launch (torch.profiler, {N_TIMED} launches): "
          f"{traced}; wrapper host time per call (enqueue): {enqueue_ms:.4f} ms")

    # the user-facing call, host clock: numpy maps (device → host copy of
    # the six maps included) and maps left on the device
    def host_ms(output):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            al.complete_analysis(args, *DOC_EXTENT, n, n, progress=False, output=output)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times[1:])[1]  # median of three, after one warm-up

    print(f"end to end complete_analysis {n}² on {card}: output='f64' "
          f"{host_ms('f64'):.3f} ms, output='f64_device' "
          f"{host_ms('f64_device'):.3f} ms (host clock, median of 3)")

    # 7. the solver library: its first-use build, registers and spills
    print(f"build: kernel B6 first use (nvcc + load), hyperinflation "
          f"{built['B6 hyperinflation'][1]:.2f} s, 3-field {built['B6 3-field'][1]:.2f} s")
    for name in ("B6 hyperinflation", "B6 3-field"):
        lib = built[name][0]
        report = [line.strip() for line in lib.build_log.read_text().splitlines()
                  if "registers" in line or "spill" in line or "Compiling entry" in line]
        print(f"ptxas, {name} (nf={lib.inflx_n_fields()}): " + " | ".join(report))

    # 8. the background path at cfg5d's full width
    rng = np.random.default_rng(0)
    f0 = np.stack([rng.uniform(1.5, 2.5, B_SOLVE), rng.uniform(1.5, 2.5, B_SOLVE)], 1)
    rkf = solve_and_check(art, args, f0, STEPS, "rkf",
                          f"B6 rkf hyperinflation {B_SOLVE}x{STEPS}")
    masses = np.linspace(0.5, 2.0, B_SOLVE)[:, None]
    solve_and_check(art, masses, f0, STEPS, "rkf",
                    f"B6 rkf hyperinflation {B_SOLVE}x{STEPS}, per-trajectory masses")
    rk4 = solve_and_check(art, args, f0, 500, "rk4", f"B6 rk4 hyperinflation {B_SOLVE}x500")
    f3 = np.random.default_rng(2).uniform(1.5, 2.5, (1024, 3))
    solve_and_check(three, np.array([1.0]), f3, 500, "rkf", "B6 rkf 3-field 1024x500")

    # 9. the on-trajectory path over every solved point of phase 8
    pts = rkf["rows"][..., :2].reshape(-1, 2)
    b5_launches, b5_max_abs = points_and_check(
        al, art, args, pts, f"B5 hyperinflation {pts.shape[0]} solved points")

    # 10. the basin survey at cfg5e's size (B6 and kernel B9, its reduction)
    rng = np.random.default_rng(1)
    f0s = np.stack([rng.uniform(1.5, 2.5, B_SOLVE), rng.uniform(1.5, 2.5, B_SOLVE)], 1)
    cuda_kernels.LAUNCHES_BY_KERNEL["B6"] = 0
    cuda_kernels.LAUNCHES_BY_KERNEL["B9"] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    survey = background.survey_initial_conditions(art, args, STEPS, f0s, np.zeros(2),
                                                  max_err=1e-6, chunk=B_SOLVE)
    survey_s = time.perf_counter() - t
    check(cuda_kernels.LAUNCHES_BY_KERNEL["B6"] > 0, "survey: no kernel launched")
    b9_launches = cuda_kernels.LAUNCHES_BY_KERNEL["B9"]
    check(b9_launches == 1, f"survey: {b9_launches} B9 launches, expected 1")
    t = time.perf_counter()
    plain_survey = background.survey_initial_conditions(art, args, STEPS, f0s, np.zeros(2),
                                                        max_err=1e-6, chunk=B_SOLVE,
                                                        engine="torch")
    plain_survey_s = time.perf_counter() - t
    for key in ("N_inflation", "H_end", "x_end", "N_span"):
        compare(torch.from_numpy(survey[key]), torch.from_numpy(plain_survey[key]),
                RTOL_SOLVER)
    check(np.array_equal(survey["ended"], plain_survey["ended"]), "survey: ended differs")
    check(survey["N_inflation"].shape == (B_SOLVE,) and survey["x_end"].shape == (B_SOLVE, 2),
          "survey: output shapes")
    print(f"basin survey hyperinflation {B_SOLVE}x{STEPS} on {card}: "
          f"{survey_s:.3f} s host clock ({B_SOLVE / survey_s:.1f} initial conditions/s), "
          f"{cuda_kernels.LAUNCHES_BY_KERNEL['B6']} kernel launch(es); ended {survey['ended'].mean():.4f}, "
          f"median N_inflation {np.nanmedian(survey['N_inflation']):.4f}; all five outputs "
          f"equal engine='torch' on the card ({plain_survey_s:.2f} s)")
    b9 = reduce_and_check(art, rkf["rows"], rkf["times"], rkf["args"][0],
                          f"B9 hyperinflation {B_SOLVE}x{STEPS} (phase 8's B6 rows)")

    # 11. timing of B6 (the plain version's time is phase 8's one call: two
    # more in turns took over a minute of the run) and of B5, in turns; B6's
    # attribution
    def solver_kernel():
        solve_cuda(art, *rkf["args"])

    single_ms = time_ms(solver_kernel, 1, 1)
    n_solver = max(3, min(100, int(500 / single_ms)))
    windows = (time_ms(solver_kernel, n_solver, 0), time_ms(solver_kernel, n_solver, 0))
    b6_ms, b6_plain_ms = sum(windows) / 2, rkf["plain_s"] * 1e3
    b6_traced = profiled_ms(solver_kernel, "solve_kernel", 3)
    pt, steps, ft, dt, max_err, _ = rkf["args"]
    one_ms = time_ms(lambda: solve_cuda(art, pt, steps, ft[:1], dt[:1], max_err, "rkf"),
                     max(3, min(100, int(500 / single_ms))), 1)
    latency_us = one_ms * 1e3 / rkf["attempts"][0].item()
    chain_ms = (STEPS - 1) * rkf["mean_attempts"] * latency_us / 1e3
    print(f"timing B6 rkf hyperinflation {B_SOLVE}x{STEPS} on {card}: kernel {b6_ms:.4f} ms "
          f"({B_SOLVE / b6_ms * 1e3:.1f} trajectories/s; windows {windows[0]:.4f}, "
          f"{windows[1]:.4f}; {n_solver} chained launches each; torch.profiler "
          f"{b6_traced}), plain torch "
          f"{b6_plain_ms:.1f} ms (phase 8's call); bound "
          f"{rkf['bound'][0]:.4f} ms ({rkf['bound'][1]}; {rkf['n_bytes']} bytes, "
          f"{rkf['n_ops']:.4e} f64 operations, {attempt_ops(art, 'rkf')} per attempt); "
          f"serial chain: trajectory 0 alone {one_ms:.4f} ms for "
          f"{rkf['attempts'][0].item()} attempts, {latency_us:.4f} us per attempt, × "
          f"{STEPS - 1} rows × {rkf['mean_attempts']:.4f} mean attempts = {chain_ms:.4f} ms; "
          f"the batch {b6_ms / one_ms:.3f}x trajectory 0 alone, whose attempts are "
          f"{rkf['attempts'][0].item()} of the batch's most {rkf['attempts'].max().item()}")
    parts_lib = built["B6 hyperinflation, instrumented"][0]
    for what, (f_b, d_b) in (("the 4096 batch", (ft, dt)), ("trajectory 0 alone",
                                                            (ft[:1], dt[:1]))):
        att = chain.attribute(parts_lib, 0, f_b, d_b, pt, steps, max_err)
        check(att["attempts_traj0"] == rkf["attempts"][0].item(),
              "B6 attribution: the instrumented copy made other attempts")
        print(f"B6 rkf attribution on {card}, {what} (scripts/probe_solver_chain.py's "
              f"clock64() stamps): trajectory 0 {att['attempts_traj0']} attempts, "
              f"{att['instrumented_cycles_per_attempt_traj0']:.0f} cycles per attempt "
              "instrumented: " + ", ".join(f"{k} {v:.0f}"
                                           for k, v in att["parts_per_attempt_traj0"].items())
              + "; stamps per attempt " + ", ".join(
                  f"{k} {v:.2f}" for k, v in att["stamps_per_attempt_traj0"].items()))

    def rk4_kernel():
        solve_cuda(art, *rk4["args"])

    rk4_single = time_ms(rk4_kernel, 1, 1)
    n_rk4 = max(3, min(100, int(500 / rk4_single)))
    windows = (time_ms(rk4_kernel, n_rk4, 0), time_ms(rk4_kernel, n_rk4, 0))
    rk4_ms, rk4_plain_ms = sum(windows) / 2, rk4["plain_s"] * 1e3
    print(f"timing B6 rk4 hyperinflation {B_SOLVE}x500 on {card}: kernel {rk4_ms:.4f} ms "
          f"(windows {windows[0]:.4f}, {windows[1]:.4f}; {n_rk4} chained launches each), "
          f"plain torch {rk4_plain_ms:.1f} ms (phase 8's call); bound {rk4['bound'][0]:.4f} ms "
          f"({rk4['bound'][1]})")

    def points_kernel():
        scan_points_cuda(art, "complete_analysis", args, pts)

    def points_plain():
        scan_points_torch(art, "complete_analysis", args, pts)

    b5_ms, b5_plain_ms, windows = in_turns(points_kernel, points_plain, N_TIMED_KERNEL,
                                           N_TIMED)
    b5_traced = profiled_ms(points_kernel, "points_scan_kernel", N_TIMED)
    n_pts = pts.shape[0]
    b5_ops = fused_point_ops(art, "complete_analysis")
    b5_bound = bound(n_pts * (16 + 6 * 8), b5_ops * n_pts)
    point_cases = [("B5a hyperinflation", "f64", args, pts, b5_bound,
                    bound(n_pts * (16 + 6 * 8), point_ops(art) * n_pts))]
    print(f"timing B5 complete_analysis at {n_pts} points on {card}: kernel {b5_ms:.4f} ms "
          f"({n_pts / b5_ms * 1e3:.4e} points/s; windows {windows[0]:.4f}, "
          f"{windows[1]:.4f}; torch.profiler {b5_traced}), plain torch "
          f"{b5_plain_ms:.4f} ms (windows {windows[2]:.4f}, {windows[3]:.4f}); bound "
          f"{b5_bound[0]:.4f} ms ({b5_bound[1]}; {n_pts * 64} bytes, {b5_ops} f64 operations "
          f"per point, each distinct operation of the fused point function once; "
          f"{point_ops(art)} counted over the three model functions as before)")

    def row(name, source, replaces, launches, max_abs, ms, plain_ms, bound_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max_abs, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
                "library_ms": None}

    # 12. the raw surfaces at cfg0's size (8000²) and flag_quantum_dif at 4096²
    start, stop, n0 = [DOC_EXTENT[0], DOC_EXTENT[2]], [DOC_EXTENT[1], DOC_EXTENT[3]], CFG0_N
    surfaces = {}
    for kind, precision, kernel_name in (("potential", "f64", "B1"), ("hesse", "f64", "B1"),
                                         ("potential", "f32", "B2")):
        label = f"{kind} hyperinflation {n0}² {precision}"
        reset_counts()
        t = time.perf_counter()
        if kind == "potential":
            user = al.calc_V_array(args, start, stop, [n0, n0], precision=precision)[None]
        else:
            user = al.calc_H_array(args, *DOC_EXTENT, [n0, n0]).reshape(4, n0, n0)
        host_s = time.perf_counter() - t
        launches = launched(kernel_name, label)
        check(user.shape[1:] == (n0, n0) and np.isfinite(user).mean() > 0.99,
              f"{label}: output shape {user.shape} or too few finite values")
        got = scan_cuda(art, kind, args, DOC_EXTENT, (n0, n0), device, precision)
        check(np.array_equal(got.cpu().numpy(), user, equal_nan=True),
              f"{label}: the user-facing call differs from the kernel's own")
        rtol = RTOL_F32 if precision == "f32" else RTOL
        max_abs, _ = grid_check(art, kind, args, DOC_EXTENT, (n0, n0), precision, got, label, rtol)
        print(f"{label}: launches={launches}; user-facing call {host_s:.3f} s host clock "
              f"(numpy, {user.nbytes} bytes)")
        surfaces[(kind, precision)] = (launches, max_abs)
        del got, user
    n_flag = 4096
    label = f"flag_quantum_dif hyperinflation {n_flag}²"
    reset_counts()
    flags = al.flag_quantum_dif(args, *DOC_EXTENT, n_flag, n_flag, progress=False,
                                accuracy=0.3)
    flag_launches = launched("B1", label)
    grads = scan_cuda(art, "gradient", args, DOC_EXTENT, (n_flag, n_flag), device)
    flag_max_abs, plain_grads = grid_check(art, "gradient", args, DOC_EXTENT, (n_flag, n_flag),
                                           "f64", grads, label)
    check(np.array_equal(flags, (plain_grads.abs() <= 0.3).all(dim=0).cpu().numpy()),
          f"{label}: the map differs from the plain version's")
    print(f"{label}: launches={flag_launches}; {flags.mean():.6f} of the points flagged "
          f"(|∂V| <= 0.3)")
    del grads, plain_grads

    # 13. the fp32 engine: complete_analysis at 4096² on B2
    n = 4096
    label = f"hyperinflation complete_analysis {n}² f32"
    reset_counts()
    maps32 = torch.stack(al.complete_analysis(args, *DOC_EXTENT, n, n, progress=False,
                                              precision="f32", output="f64_device"))
    b2_launches = launched("B2", label)
    check(maps32.dtype == torch.float32 and maps32.shape == (6, n, n), f"{label}: maps")
    # the CPU's f32 divides where the card multiplies by a reciprocal, and the
    # maps amplify that last bit (ε_H's condition reaches 1e4): on the CPU
    # rows the masks must agree and the values are reported
    b2_max_abs, plain32 = grid_check(art, "complete_analysis", args, DOC_EXTENT, (n, n), "f32",
                                     maps32, label, RTOL_F32, cpu_rtol=float("inf"))
    plain64 = scan_torch(art, "complete_analysis", args, DOC_EXTENT, (n, n), device)
    diff = (maps32.double() - plain32.double()).abs()
    within = ((diff <= RTOL_F32 * plain32.double().abs()) | (maps32 == plain32)
              | (torch.isnan(maps32) & torch.isnan(plain32)))
    settled = torch.isfinite(plain64) & ((plain32.double() - plain64).abs()
                                          <= 1e-4 * plain64.abs())
    check(bool(within[settled].all()), f"{label}: a settled point beyond rtol {RTOL_F32}")
    print(f"{label}: launches={b2_launches}; share within rtol {RTOL_F32} of the plain f32 "
          f"version {within.double().mean().item():.6f}; points where the f32 and f64 plain "
          f"versions agree within 1e-4: {settled.double().mean().item():.6f}, all within")
    del maps32, plain32, plain64, diff, within, settled

    # 14. D5 on B1 (the TPU's range-extended engine maps onto f64)
    n_d5 = 1024
    label = f"D5 complete_analysis {n_d5}² f64"
    d5_al = GeneralisedAL(d5, device=device, validate_basis=False)
    reset_counts()
    d5_maps = torch.stack(d5_al.complete_analysis(d5_args, *D5_EXTENT, n_d5, n_d5,
                                                  progress=False, output="f64_device"))
    d5_launches = launched("B1", label)
    # D5's V_vw cancels catastrophically (ROADMAP C7): the last bit in which
    # the CPU's log/cos/sqrt part from CUDA's moves consistency, η_∥ and δ
    # far beyond 5e-10, so on the CPU rows the masks must agree and the
    # values are reported
    d5_max_abs, _ = grid_check(d5, "complete_analysis", d5_args, D5_EXTENT, (n_d5, n_d5), "f64",
                               d5_maps, label, cpu_rtol=float("inf"))
    print(f"{label}: launches={d5_launches}; ε_V finite share "
          f"{torch.isfinite(d5_maps[1]).double().mean().item():.6f}, nanmax(consistency) "
          f"{nanmax(d5_maps[0]):.6f}")
    check(nanmax(d5_maps[0]) <= 1.0 and torch.isfinite(d5_maps[1]).double().mean() > 0.5,
          f"{label}: consistency above 1 or too few finite ε_V")

    # 15. EGNO on B4 (double-double)
    n_e = 2048
    egno_al = GeneralisedAL(egno, device=device, validate_basis=False)
    b4 = {}
    for kind in ("consistency_rapidturn", "complete_analysis"):
        label = f"EGNO {kind} {n_e}² dd"
        reset_counts()
        out = getattr(egno_al, kind)(egno_args, *EGNO_EXTENT, n_e, n_e, progress=False,
                                     precision="dd", output="f64_device")
        out = torch.stack(out) if isinstance(out, tuple) else out[None]
        b4[kind] = [launched("B4", label)]
        b4[kind].append(grid_check(egno, kind, egno_args, EGNO_EXTENT, (n_e, n_e), "dd", out,
                                   label, rows=8)[0])
        check(nanmax(out[0]) <= 1.0, f"{label}: consistency above 1")
    reset_counts()
    v_dd = torch.from_numpy(egno_al.calc_V_array(egno_args, EGNO_EXTENT[::2], EGNO_EXTENT[1::2],
                                                 [n_e, n_e], precision="dd"))
    h_dd = torch.from_numpy(egno_al.calc_H_array(egno_args, *EGNO_EXTENT, [n_e, n_e],
                                                 precision="dd")).reshape(4, n_e, n_e)
    eps_dd = scan_cuda(egno, "epsilon_v", egno_args, EGNO_EXTENT, (n_e, n_e), device, "dd")[0]
    launched("B4", "EGNO calc_V_array/calc_H_array dd")
    f64_model = [scan_torch(egno, kind, egno_args, EGNO_EXTENT, (n_e, n_e), device)
                 for kind in ("potential", "hesse", "epsilon_v")]
    import mpmath

    reference = mp_model(egno, egno_args)
    rng = np.random.default_rng(15)
    idx = list(zip(rng.integers(0, n_e, 64), rng.integers(0, n_e, 64)))
    x0a, x0b, x1a, x1b = EGNO_EXTENT
    dx0, dx1 = (x0b - x0a) / n_e, (x1b - x1a) / n_e
    worst_dd, worst_f64 = [0.0] * 5, [0.0] * 5
    with mpmath.workdps(40):
        for i, j in idx:
            i, j = int(i), int(j)
            exact = reference(mpmath.mpf(x0a) + i * mpmath.mpf(dx0),
                              mpmath.mpf(x1a) + j * mpmath.mpf(dx1))
            rounded = reference(mpmath.mpf(x0a + i * dx0), mpmath.mpf(x1a + j * dx1))
            v = v_dd[i, j].item()
            got = [v, h_dd[0, i, j].item(), h_dd[2, i, j].item(), h_dd[3, i, j].item(),
                   2.0 * eps_dd[i, j].item() * v * v]
            v64 = f64_model[0][0, i, j].item()
            f64 = [v64, f64_model[1][0, i, j].item(), f64_model[1][2, i, j].item(),
                   f64_model[1][3, i, j].item(), 2.0 * f64_model[2][0, i, j].item() * v64 * v64]
            for k in range(5):
                worst_dd[k] = max(worst_dd[k], abs(float((got[k] - exact[k]) / exact[k])))
                worst_f64[k] = max(worst_f64[k], abs(float((f64[k] - rounded[k]) / rounded[k])))
    names = ("V", "V_vv", "V_wv", "V_ww", "|∇V|²")
    print(f"EGNO {n_e}² dd, kernel B4 at 64 grid points vs 40-digit mpmath, largest relative "
          "error (f64 beside it): " + ", ".join(
              f"{nm} {a:.3e} (f64 {b:.3e})" for nm, a, b in zip(names, worst_dd, worst_f64)))
    check(max(worst_dd) <= RTOL_MPMATH, f"EGNO dd: a model function beyond {RTOL_MPMATH} "
          "of mpmath")
    del v_dd, h_dd, eps_dd, f64_model, out

    # 16. B5b over 1,048,576 points spread over the EGNO window
    n_egno = 1 << 20
    rng = np.random.default_rng(16)
    egno_pts = torch.tensor(np.stack([rng.uniform(x0a, x0b, n_egno),
                                      rng.uniform(x1a, x1b, n_egno)], 1), device=device)
    label = f"B5b EGNO {n_egno} points dd"
    reset_counts()
    ot = egno_al.complete_analysis_ot(egno_args, egno_pts, progress=False, precision="dd")
    singles = {kind: getattr(egno_al, kind + "_ot")(egno_args, egno_pts, progress=False,
                                                    precision="dd")
               for kind in ("consistency", "consistency_rapidturn", "epsilon_v")}
    b5b_launches = launched("B5b", label)
    b5b_max_abs = 0.0
    for kind, user in [("complete_analysis", np.concatenate(ot, axis=1).T), *singles.items()]:
        got = scan_points_cuda(egno, kind, egno_args, egno_pts, "dd")
        check(np.array_equal(got.cpu().numpy().reshape(user.shape), user, equal_nan=True),
              f"{label} {kind}: the user-facing call differs from the kernel's own")
        rel, absolute, same = compare(got, scan_points_torch(egno, kind, egno_args, egno_pts,
                                                             "dd"))
        b5b_max_abs = max(b5b_max_abs, absolute)
        cpu_rel, _, cpu_same = compare(got[:, :4096].cpu(), scan_points_torch(
            egno, kind, egno_args, egno_pts[:4096].cpu(), "dd"))
        print(f"{label} {kind}: kernel vs plain torch on the card: max_rel={rel:.3e} "
              f"max_abs={absolute:.3e} bit_identical={same:.6f}; first 4096 points vs the "
              f"CPU: max_rel={cpu_rel:.3e} bit_identical={cpu_same:.6f}")
    print(f"{label}: launches={b5b_launches}")

    # 17. timing of B2, B4, B5b and B1's new kinds, each in turns with its
    # plain version; the grid kernels through direct_grid (the wrapper's host
    # work per call would set the pace of the cheap kinds)
    timed_rows = []

    def timed_row(name, source, replaces, launches, max_abs, kernel, plain, n_bytes, n_ops,
                  ops_per_s=F64_OPS_PER_S):
        ms, plain_ms, windows, n_k, n_p = adaptive_turns(kernel, plain)
        bnd = bound(n_bytes, n_ops, ops_per_s)
        print(f"timing {name} on {card}: kernel {ms:.4f} ms (windows {windows[0]:.4f}, "
              f"{windows[1]:.4f}; {n_k} chained launches each), plain torch {plain_ms:.4f} ms "
              f"(windows {windows[2]:.4f}, {windows[3]:.4f}; {n_p} calls each); bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}; {n_bytes} bytes, {n_ops:.4e} operations)")
        timed_rows.append(row(name, source, replaces, launches, max_abs, ms, plain_ms, bnd))

    grid_src, pk = "inflatox_torch/csrc/grid_scan.cu", "inflatox_tpu/ops/pallas_kernels.py"
    big = (n0, n0)
    timed_row(f"grid_scan_b1_potential_{n0}", grid_src, f"{pk}:388",
              *surfaces[("potential", "f64")],
              direct_grid(art, "potential", args, DOC_EXTENT, big, device),
              lambda: scan_torch(art, "potential", args, DOC_EXTENT, big, device),
              n0 * n0 * 8, lowered_ops(art.potential) * n0 * n0)
    timed_row(f"grid_scan_b1_hesse_{n0}", grid_src, f"{pk}:388", *surfaces[("hesse", "f64")],
              direct_grid(art, "hesse", args, DOC_EXTENT, big, device),
              lambda: scan_torch(art, "hesse", args, DOC_EXTENT, big, device),
              4 * n0 * n0 * 8, lowered_ops(art._hesse) * n0 * n0)
    timed_row(f"grid_scan_b1_gradient_{n_flag}", grid_src, f"{pk}:388", flag_launches,
              flag_max_abs,
              direct_grid(art, "gradient", args, DOC_EXTENT, (n_flag, n_flag), device),
              lambda: scan_torch(art, "gradient", args, DOC_EXTENT, (n_flag, n_flag), device),
              2 * n_flag * n_flag * 8, lowered_ops(art._grad) * n_flag * n_flag)
    timed_row(f"grid_scan_b2_f32_potential_{n0}", grid_src, f"{pk}:231",
              *surfaces[("potential", "f32")],
              direct_grid(art, "potential", args, DOC_EXTENT, big, device, "f32"),
              lambda: scan_torch(art, "potential", args, DOC_EXTENT, big, device, "f32"),
              n0 * n0 * 4, lowered_ops(art.potential) * n0 * n0, F32_OPS_PER_S)
    timed_row(f"grid_scan_b2_f32_complete_analysis_{n}", grid_src, f"{pk}:231", b2_launches,
              b2_max_abs,
              direct_grid(art, "complete_analysis", args, DOC_EXTENT, (n, n), device, "f32"),
              lambda: scan_torch(art, "complete_analysis", args, DOC_EXTENT, (n, n), device,
                                 "f32"),
              6 * n * n * 4, point_ops(art) * n * n, F32_OPS_PER_S)
    # the operation-bound rows: counted for the staged kernel's work, the
    # count of whole model functions at every point beside it
    d5_ops = staged_ops(d5, "complete_analysis", "f64", n_d5, n_d5)
    d5_whole = point_ops(d5) * n_d5 * n_d5
    timed_row(f"grid_scan_b1_d5_{n_d5}", grid_src, f"{pk}:835", d5_launches, d5_max_abs,
              direct_grid(d5, "complete_analysis", d5_args, D5_EXTENT, (n_d5, n_d5), device),
              lambda: scan_torch(d5, "complete_analysis", d5_args, D5_EXTENT, (n_d5, n_d5),
                                 device),
              6 * n_d5 * n_d5 * 8, d5_ops)
    recounts = [("B1 on D5", d5_whole, d5_ops)]
    for kind, planes in (("consistency_rapidturn", 1), ("complete_analysis", 6)):
        b4_ops = staged_ops(egno, kind, "dd", n_e, n_e)
        timed_row(f"grid_scan_b4_dd_egno_{kind}_{n_e}", grid_src, f"{pk}:1536", *b4[kind],
                  direct_grid(egno, kind, egno_args, EGNO_EXTENT, (n_e, n_e), device, "dd"),
                  lambda kind=kind: scan_torch(egno, kind, egno_args, EGNO_EXTENT, (n_e, n_e),
                                               device, "dd"),
                  planes * n_e * n_e * 8, b4_ops)
        recounts.append((f"B4 {kind}", dd_point_ops(egno, kind) * n_e * n_e, b4_ops))
    b5b_ops = fused_point_ops(egno, "complete_analysis", "dd")
    timed_row(f"points_scan_b5b_dd_egno_{n_egno}", grid_src, f"{pk}:1101", b5b_launches,
              b5b_max_abs,
              lambda: scan_points_cuda(egno, "complete_analysis", egno_args, egno_pts, "dd"),
              lambda: scan_points_torch(egno, "complete_analysis", egno_args, egno_pts, "dd"),
              n_egno * (16 + 6 * 8), b5b_ops * n_egno)
    recounts.append(("B5b", dd_point_ops(egno, "complete_analysis") * n_egno, b5b_ops * n_egno))
    point_cases.append(("B5b EGNO dd", "egno", egno_args, egno_pts,
                        bound(n_egno * (16 + 6 * 8), b5b_ops * n_egno),
                        bound(n_egno * (16 + 6 * 8),
                              dd_point_ops(egno, "complete_analysis") * n_egno)))

    t_phase18 = time.perf_counter()
    print(f"phases 1-17: {t_phase18 - t_start:.1f} s")

    # 18. the parameter sweep at bench cfg5's size, f64 (kernel B7a)
    from inflatox_torch.ops import cuda_kernels
    from inflatox_torch.ops.cuda_kernels import scan_batch_cuda, scan_batch_torch
    from inflatox_torch.parallel import parameter_sweep

    masses = np.linspace(0.5, 2.0, SWEEP_SETS)[:, None]
    sw = (SWEEP_N, SWEEP_N)
    label = f"sweep hyperinflation {SWEEP_SETS} masses x {SWEEP_N}² f64"
    reset_counts()
    t = time.perf_counter()
    sweep = parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False)
    sweep_s = time.perf_counter() - t
    b7a_launches = launched("B7a", label)
    by_kernel = {k: v for k, v in cuda_kernels.LAUNCHES_BY_KERNEL.items() if v}
    check(by_kernel == {"B7a": 1}, f"{label}: launches {by_kernel}, expected one B7a launch")
    check(sweep.shape == (SWEEP_SETS, 6, *sw) and sweep.dtype == np.float64,
          f"{label}: result {sweep.shape} {sweep.dtype}")
    check(np.nanmax(sweep[:, 0]) <= 1.0 and np.isfinite(sweep[:, 1]).mean() > 0.5,
          f"{label}: consistency above 1 or too few finite ε_V")
    got = scan_batch_cuda(art, "complete_analysis", masses, DOC_EXTENT, sw, device)
    check(np.array_equal(got.cpu().numpy(), sweep, equal_nan=True),
          f"{label}: the user-facing call differs from the kernel's own")
    rel, b7a_max_abs, same = compare(got, scan_batch_torch(art, "complete_analysis", masses,
                                                           DOC_EXTENT, sw, device))
    singles_same = min(compare(got[s], scan_cuda(art, "complete_analysis", masses[s],
                                                 DOC_EXTENT, sw, device), 0.0)[2]
                       for s in range(SWEEP_SETS))
    check(singles_same == 1.0, f"{label}: a set differs from its single B1 scan")
    cpu_rel, _, cpu_same = compare(got[:4].cpu(), scan_batch_torch(
        art, "complete_analysis", masses[:4], DOC_EXTENT, sw, "cpu"))
    print(f"{label}: launches by kernel {by_kernel}; {sweep.nbytes} bytes of maps, "
          f"user-facing call {sweep_s:.3f} s host clock; kernel vs plain torch on the card: "
          f"max_rel={rel:.3e} max_abs={b7a_max_abs:.3e} bit_identical={same:.6f}; each of the "
          f"{SWEEP_SETS} sets vs its single B1 scan: bit_identical={singles_same:.6f}; sets 0-3 "
          f"vs plain torch on the CPU: max_rel={cpu_rel:.3e} bit_identical={cpu_same:.6f}")
    reset_counts()
    reduced = parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False,
                              reduce_fn=consistency_nanmin)
    launched("B7a", f"{label}, reduced")
    check(reduced.shape == (SWEEP_SETS,) and np.array_equal(
        reduced, np.nanmin(sweep[:, 0], axis=(1, 2))),
        f"{label}: the on-device nanmin differs from the full maps'")
    print(f"{label}, reduce_fn=nanmin of consistency (bench cfg5's form): equal to the full "
          f"maps' reduction; min over the sweep {reduced.min():.6f}")
    sweep_dev = got

    # 19. the same sweep in f32 (B7b); EGNO in double-double (B7d);
    # flag_quantum_dif over the sweep
    label = f"sweep hyperinflation {SWEEP_SETS} masses x {SWEEP_N}² f32"
    reset_counts()
    sweep32 = parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False, precision="f32")
    b7b_launches = launched("B7b", label)
    got32 = scan_batch_cuda(art, "complete_analysis", masses, DOC_EXTENT, sw, device, "f32")
    check(sweep32.dtype == np.float32 and np.array_equal(got32.cpu().numpy(), sweep32,
                                                         equal_nan=True),
          f"{label}: the user-facing call differs from the kernel's own")
    rel, b7b_max_abs, same = compare(got32, scan_batch_torch(
        art, "complete_analysis", masses, DOC_EXTENT, sw, device, "f32"), RTOL_F32)
    singles_same = min(compare(got32[s], scan_cuda(art, "complete_analysis", masses[s],
                                                   DOC_EXTENT, sw, device, "f32"), 0.0)[2]
                       for s in range(SWEEP_SETS))
    print(f"{label}: launches={b7b_launches}; kernel vs plain torch on the card: "
          f"max_rel={rel:.3e} max_abs={b7b_max_abs:.3e} bit_identical={same:.6f}; each set vs "
          f"its single B2 scan: bit_identical={singles_same:.6f}")
    del got32, sweep32
    c_values = np.linspace(*EGNO_SWEEP_C)
    egno_batch = np.stack([inflatox_torch.models._args_by_symbol(egno.model, {**EGNO_ARGS, "c": c})
                           for c in c_values])
    label = f"sweep EGNO consistency_rapidturn {len(c_values)} values of c x {SWEEP_N}² dd"
    reset_counts()
    sweep_dd = parameter_sweep(egno_al, egno_batch, EGNO_EXTENT, sw, progress=False,
                               precision="dd", kind="consistency_rapidturn")
    b7d_launches = launched("B7d", label)
    got_dd = scan_batch_cuda(egno, "consistency_rapidturn", egno_batch, EGNO_EXTENT, sw, device,
                             "dd")
    check(np.array_equal(got_dd.cpu().numpy(), sweep_dd, equal_nan=True),
          f"{label}: the user-facing call differs from the kernel's own")
    rel, b7d_max_abs, same = compare(got_dd, scan_batch_torch(
        egno, "consistency_rapidturn", egno_batch, EGNO_EXTENT, sw, device, "dd"))
    singles_same = min(compare(got_dd[s], scan_cuda(egno, "consistency_rapidturn", egno_batch[s],
                                                    EGNO_EXTENT, sw, device, "dd"), 0.0)[2]
                       for s in range(len(c_values)))
    check(singles_same == 1.0, f"{label}: a set differs from its single B4 scan")
    check(nanmax(got_dd) <= 1.0, f"{label}: consistency above 1")
    print(f"{label}: launches={b7d_launches}; kernel vs plain torch on the card: "
          f"max_rel={rel:.3e} max_abs={b7d_max_abs:.3e} bit_identical={same:.6f}; each set vs "
          f"its single B4 scan: bit_identical={singles_same:.6f}")
    del got_dd
    label = f"sweep flag_quantum_dif hyperinflation {SWEEP_SETS} masses x {SWEEP_N}²"
    reset_counts()
    flags = parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False,
                            kind="flag_quantum_dif", accuracy=0.3)
    launched("B7a", label)
    plain_flags = (scan_batch_torch(art, "gradient", masses, DOC_EXTENT, sw, device).abs()
                   <= 0.3).all(dim=1, keepdim=True)
    check(flags.dtype == bool and np.array_equal(flags, plain_flags.cpu().numpy()),
          f"{label}: the mask differs from the plain version's")
    print(f"{label}: mask equal to the plain version's; {flags.mean():.6f} of the points "
          "flagged (|∂V| <= 0.3)")
    del plain_flags

    # 20. kill and resume (bench cfg5c, on the port)
    torch.cuda.empty_cache()
    rehearse_kill_resume(art, device, card)

    # 21. timing: B7a, B7b, B7d in turns with their plain versions; B7a
    # against 32 chained B1 launches; parameter_sweep on the host clock
    sweep_bytes = SWEEP_SETS * 6 * SWEEP_N * SWEEP_N
    timed_row(f"grid_scan_b7a_sweep_{SWEEP_SETS}x{SWEEP_N}", grid_src, f"{pk}:536",
              b7a_launches, b7a_max_abs,
              direct_grid(art, "complete_analysis", masses, DOC_EXTENT, sw, device),
              lambda: scan_batch_torch(art, "complete_analysis", masses, DOC_EXTENT, sw, device),
              sweep_bytes * 8, point_ops(art) * SWEEP_SETS * SWEEP_N * SWEEP_N)

    def b1_chain():
        for s in range(SWEEP_SETS):
            scan_cuda(art, "complete_analysis", masses[s], DOC_EXTENT, sw, device)

    # the same 32 launches through the library's C entry, parameters and
    # outputs made beforehand: the card's time without the wrapper's
    lib = load_grid_scan(art.cuda_source())
    p_sets = torch.tensor(masses, device=device)
    out_sets = torch.empty((SWEEP_SETS, 6, *sw), dtype=torch.float64, device=device)
    ptrs = [(p_sets[s].data_ptr(), out_sets[s].data_ptr()) for s in range(SWEEP_SETS)]
    geometry = (DOC_EXTENT[0], (DOC_EXTENT[1] - DOC_EXTENT[0]) / SWEEP_N, DOC_EXTENT[2],
                (DOC_EXTENT[3] - DOC_EXTENT[2]) / SWEEP_N, SWEEP_N, SWEEP_N)

    def b1_raw_chain():
        stream = torch.cuda.current_stream().cuda_stream
        for p_ptr, out_ptr in ptrs:
            lib.inflx_grid_scan(0, p_ptr, out_ptr, *geometry, stream)

    b1_raw_chain()
    check(bool(((out_sets == sweep_dev) | (out_sets.isnan() & sweep_dev.isnan())).all()),
          "cfg5: the raw B1 launches differ from B7a's sets")
    batch_ms, chain_ms, windows = in_turns(
        lambda: scan_batch_cuda(art, "complete_analysis", masses, DOC_EXTENT, sw, device),
        b1_chain, N_TIMED_KERNEL, N_TIMED_KERNEL // 4, 3)
    raw_ms = time_ms(b1_raw_chain, N_TIMED_KERNEL // 4)
    print(f"timing cfg5 on {card}: one B7a launch {batch_ms:.4f} ms (windows {windows[0]:.4f}, "
          f"{windows[1]:.4f}) against {SWEEP_SETS} chained B1 launches through scan_cuda "
          f"{chain_ms:.4f} ms (windows {windows[2]:.4f}, {windows[3]:.4f}): "
          f"{chain_ms / batch_ms:.3f}x; the {SWEEP_SETS} B1 launches through the C entry "
          f"(no wrapper) {raw_ms:.4f} ms: {raw_ms / batch_ms:.3f}x")
    del p_sets, out_sets, sweep_dev
    timed_row(f"grid_scan_b7b_f32_sweep_{SWEEP_SETS}x{SWEEP_N}", grid_src, f"{pk}:621",
              b7b_launches, b7b_max_abs,
              direct_grid(art, "complete_analysis", masses, DOC_EXTENT, sw, device, "f32"),
              lambda: scan_batch_torch(art, "complete_analysis", masses, DOC_EXTENT, sw, device,
                                       "f32"),
              sweep_bytes * 4, point_ops(art) * SWEEP_SETS * SWEEP_N * SWEEP_N, F32_OPS_PER_S)
    n_dd = len(c_values) * SWEEP_N * SWEEP_N
    b7d_ops = staged_ops(egno, "consistency_rapidturn", "dd", SWEEP_N, SWEEP_N, len(c_values))
    recounts.append(("B7d", dd_point_ops(egno, "consistency_rapidturn") * n_dd, b7d_ops))
    timed_row(f"grid_scan_b7d_dd_egno_sweep_{len(c_values)}x{SWEEP_N}", grid_src, f"{pk}:1689",
              b7d_launches, b7d_max_abs,
              direct_grid(egno, "consistency_rapidturn", egno_batch, EGNO_EXTENT, sw, device,
                          "dd"),
              lambda: scan_batch_torch(egno, "consistency_rapidturn", egno_batch, EGNO_EXTENT, sw,
                                       device, "dd"),
              n_dd * 8, b7d_ops)
    for name, whole, staged in recounts:
        how = "fused point function" if name == "B5b" else "staged kernel"
        print(f"operation bound of {name}: {staged:.4e} f64 operations for the {how} "
              f"({bound(0, staged)[0]:.4f} ms), {whole:.4e} with whole model functions at "
              f"every point ({bound(0, whole)[0]:.4f} ms)")

    def sweep_host_s(fn, clear=None, repeats=3):
        """Median host seconds of ``fn()`` over ``repeats`` calls after one
        warm-up, each started and ended synchronised; ``clear`` runs
        before each call, outside the clock."""
        times = []
        for _ in range(repeats + 1):
            if clear:
                clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return sorted(times[1:])[len(times[1:]) // 2]

    ckdir = os.path.join(SWEEP_DIR, "timing")

    def clear():
        shutil.rmtree(ckdir, ignore_errors=True)

    full_s = sweep_host_s(lambda: parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False))
    reduced_s = sweep_host_s(lambda: parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False,
                                                     reduce_fn=consistency_nanmin))
    chunk8_s = sweep_host_s(lambda: parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False,
                                                    chunk_size=8))
    ck8_s = sweep_host_s(lambda: parameter_sweep(al, masses, DOC_EXTENT, sw, progress=False,
                                                 chunk_size=8, checkpoint_dir=ckdir), clear)
    print(f"parameter_sweep on the host clock, cfg5 ({SWEEP_SETS} x {SWEEP_N}², "
          f"{sweep_bytes * 8} bytes of maps) on {card}, median of 3: full maps {full_s:.4f} s, "
          f"reduce_fn {reduced_s:.4f} s; chunk 8 {chunk8_s:.4f} s, chunk 8 checkpointed "
          f"{ck8_s:.4f} s")
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    print(f"phases 18-21: {time.perf_counter() - t_phase18:.1f} s; the whole run "
          f"{time.perf_counter() - t_start:.1f} s")

    # 22-27. kernel B8: the special functions alone, then on the main paths
    t_phase22 = time.perf_counter()
    special_rows, special_points = special_phases(special, device, card, row, timed_row,
                                                  grid_src, pk, built["B6 S2, instrumented"][0])
    print(f"phases 22-27: {time.perf_counter() - t_phase22:.1f} s; the whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    point_cases += [(name, name.split()[1].lower(), np.array(SPECIAL_ARGS), pts, bnd, old)
                    for name, (pts, bnd, old) in special_points.items()]
    # 28. geometry, observables and fitting on the card
    t_phase28 = time.perf_counter()
    print(f"phase 28 models (α-attractor, hyperbolic plane) built in {t_cmb_models:.2f} s "
          f"(host, phase 2; the card: {card})")
    cmb_launches = cmb_phase(art, args, al, aa, aa_args, hyperbolic, special["S2"], device, card)
    print(f"phase 28 on {card}: {time.perf_counter() - t_phase28:.1f} s; launches on its paths: "
          f"B6 {cmb_launches['B6']}, B1 {cmb_launches['B1']}; the whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    # 29. perturbation spectra on the card
    t_phase29 = time.perf_counter()
    print(f"phase 29 models (bench's quadratic, the curved two-field model) built in "
          f"{t_spectra_models:.2f} s (host, phase 2; the card: {card})")
    spectra_launches, spectra = spectra_phase(quad, curved, c_args, device, card)
    print(f"phase 29 on {card}: {time.perf_counter() - t_phase29:.1f} s; B6 launches on its "
          f"paths: {spectra_launches}; the whole run {time.perf_counter() - t_start:.1f} s")
    print("phase 29 summary: " + json.dumps(spectra))
    # 30. posterior sampling on the card
    t_phase30 = time.perf_counter()
    print(f"phase 30 model (examples/posterior.py's quadratic) built in {t_post_model:.2f} s "
          f"(host, phase 2; the card: {card})")
    posterior = posterior_phase(post_art, device, card)
    print(f"phase 30 on {card}: {time.perf_counter() - t_phase30:.1f} s; kernel launches on its "
          f"paths: none (B1-B8 counts unchanged); the whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print("phase 30 summary: " + json.dumps(posterior))
    # 31. many devices: meshes of the parallel package on the card
    t_phase31 = time.perf_counter()
    meshes = mesh_phase(art, args, al, egno, egno_args, quad, post_art, rkf, pts, device, card)
    print(f"phase 31 on {card}: {time.perf_counter() - t_phase31:.1f} s; the whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print("phase 31 summary: " + json.dumps(meshes))
    # 32. the examples on the card; the C oracle on its host
    t_phase32 = time.perf_counter()
    examples = examples_phase(example_modules, art, args, device, card)
    print(f"phase 32 on {card}: {time.perf_counter() - t_phase32:.1f} s; the whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    print("phase 32 summary: " + json.dumps(examples))
    if parent_jobs:
        parent_turns(parent_jobs, point_cases, {"f64": art, "egno": egno, **{
            k.lower(): special[k] for k in ("S1", "S2", "S3")}}, card)

    kernels = [
        row("grid_scan_b1", "inflatox_torch/csrc/grid_scan.cu",
            "inflatox_tpu/ops/pallas_kernels.py:388", b1_launches, b1_max_abs, b1_ms,
            b1_plain_ms, b1_bound),
        row("points_scan_b5", "inflatox_torch/csrc/grid_scan.cu",
            "inflatox_tpu/ops/pallas_kernels.py:1055", b5_launches, b5_max_abs, b5_ms,
            b5_plain_ms, b5_bound),
        row("solver_b6_rkf", "inflatox_torch/csrc/solver.cu",
            "inflatox_tpu/ops/pallas_solver.py:173", rkf["launches"] + spectra_launches,
            rkf["max_abs"], b6_ms, b6_plain_ms, rkf["bound"]),
        row("solver_b6_rk4", "inflatox_torch/csrc/solver.cu",
            "inflatox_tpu/ops/pallas_solver.py:173", rk4["launches"], rk4["max_abs"], rk4_ms,
            rk4_plain_ms, rk4["bound"]),
        row("survey_reduce_b9", "inflatox_torch/csrc/survey.cuh",
            "none (inflatox_tpu/background.py:370 _survey_reduce is jitted jnp)",
            b9_launches + b9["launches"], b9["max_abs"], b9["ms"], b9["plain_ms"], b9["bound"]),
        *timed_rows,
    ]
    old_rows = [k for k in kernels if k["name"] in BEFORE_MS]
    kernels += special_rows
    print(f"kernel times on {card} beside those before the staged grid kernel and the "
          "flat-loop solver (PERF.md §5, NVIDIA H100 80GB HBM3, 700 W; another run, the grid "
          "kernels then timed through their wrappers, so a guide: scripts/probe_grid_stages.py "
          "and scripts/probe_solver_chain.py compare the trees in turns): " + "; ".join(
              f"{k['name']} {k['ms']:.4f} ms (before {BEFORE_MS[k['name']]:.4f}, "
              f"{BEFORE_MS[k['name']] / k['ms']:.2f}x)" for k in old_rows))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sweep-worker"]:
        sys.exit(sweep_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--trace-worker"]:
        sys.exit(trace_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--dist-worker"]:
        try:
            sys.exit(dist_worker(sys.argv[2:]))
        except SmokeFailure as e:
            print(f"chip_smoke --dist-worker: FAILED: {e}", flush=True)
            sys.exit(1)
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    finally:
        if "joblib" in sys.modules:  # the symbolic build's worker pool
            from joblib.externals.loky import get_reusable_executor

            get_reusable_executor().shutdown(wait=True)
    sys.exit(code)
