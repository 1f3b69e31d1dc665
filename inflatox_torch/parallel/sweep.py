"""Sharded grid scans and parameter sweeps.

The port of ``inflatox_tpu/parallel/sweep.py``:

* :func:`sharded_scan` — one parameter set, the grid's rows split over the
  mesh axis ``"grid"``: each slot launches one grid scan (kernel B1, B2 or
  B4) of its rows, each row at its global index of the whole grid
  (``rows=`` of :func:`~inflatox_torch.ops.cuda_kernels.scan_cuda`), so the
  joined maps are bit for bit the unsharded scan's.  No input is split.
* :func:`sharded_scan_ot` — the analysis at (n, 2) points split evenly
  over the axis (last point repeated as padding), one B5a (f64) or B5b
  (double-double) launch a slot.
* :func:`parameter_sweep` — a batch of parameter sets, one chunk at a time;
  a chunk is one launch of a batched grid scan kernel
  (:func:`~inflatox_torch.ops.cuda_kernels.scan_batch_cuda`: B7a in f64,
  B7b in f32, B7d in double-double), whose output is the (S, n_out, N0,
  N1) stack the JAX sweep returns; with ``mesh=`` the chunk is padded to
  the ``"sweep"`` axis and split, one launch a slot.  ``engine="torch"``
  runs the plain PyTorch version instead, on any device.  A ``reduce_fn``
  runs on the device as ``torch.func.vmap(reduce_fn)`` (per slot), the
  counterpart of the JAX package's ``jax.vmap(reduce_fn)``, so huge sweeps
  bring only the reductions to the host.

Checkpointing, as in the JAX package: each chunk's result goes to
``chunk_{i:06d}.npy`` through temp file and rename on a one-worker writer
thread, ``manifest.json`` fingerprints the inputs (with the precision
always, and the accuracy of ``flag_quantum_dif``; not the mesh, so a sweep
resumes on another mesh), a resume loads the chunks that exist and refuses
a directory written by a different sweep.  With several processes, process
0 alone writes the directory and decides which chunks exist; each process
loads them (a shared file system).  Not ported: the two legacy manifest
forms the JAX package still accepts (``_manifest_matches``), which only
directories written by its older releases carry.

The chunk loop is one chunk deep: chunk i's copy to the host is enqueued
(non-blocking, into pinned memory) with an event right after its launch
(each slot's, with a mesh) and before chunk i+1's, and the host waits on
that event only once chunk i+1 is launched.  So the wait ends when chunk
i's kernel and copy are done, and chunk i's host work (the copy into the
result, the checkpoint write) overlaps chunk i+1's kernel.  A ``.cpu()``
called after chunk i+1's launch would wait for that kernel too, on the same
stream.  At most one checkpoint write is queued behind the one being
written: where writes are the slower side, the loop waits for the writer
instead of piling chunk results up in memory (with full maps in chunks of 8
that was also 1.48× faster on an H100's host, PERF.md).

Spans of the chunk loop, per chunk and slot (``utils.profiling``):
``inflx.sweep.launch`` (the batched scan), ``inflx.sweep.reduce``
(``vmap(reduce_fn)``), ``inflx.shards.stage`` and ``inflx.shards.wait``
(``mesh.py``: the copies to the host and the wait for them),
``inflx.sweep.store`` (the copy into the numpy result) and
``inflx.sweep.write`` (the checkpoint file, on the writer thread).
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.cuda_kernels import (
    POINT_KINDS,
    PRECISIONS,
    evaluate_points,
    scan_batch_cuda,
    scan_batch_torch,
    scan_cuda,
    scan_points_cuda,
    scan_points_torch,
    scan_torch,
)
from ..ops.dd import DD
from ..utils.devices import resolve_engine, resolve_precision
from ..utils.logging import Progress
from ..utils.profiling import annotate
from .mesh import (
    Mesh,
    agree,
    check_mesh,
    gather_shards,
    launch_shards,
    pad_rows,
)

__all__ = ["sharded_scan", "sharded_scan_ot", "parameter_sweep"]

#: scan kinds a sweep accepts (the JAX package's ``_SWEEP_KINDS``)
_SWEEP_KINDS = (
    "complete_analysis", "consistency", "consistency_rapidturn",
    "epsilon_v", "potential", "hesse", "gradient", "flag_quantum_dif",
)


def _hash_code_object(h, code, _depth=0):
    """Hash a code object recursively: a nested code object (a lambda inside
    ``reduce_fn``) reprs with its memory address, which differs per
    process; hash its bytecode and constants instead."""
    h.update(code.co_code)
    for c in code.co_consts:
        if isinstance(c, types.CodeType) and _depth < 8:
            _hash_code_object(h, c, _depth + 1)
        else:
            h.update(repr(c).encode())


def _fp_value(h, v, depth=0):
    """Fold a closure-cell or default value into the fingerprint hash,
    reproducibly across processes: a captured callable hashes by its
    bytecode (recursively), an object whose repr is the default address
    form by its type name."""
    code = getattr(v, "__code__", None)
    if code is not None and depth < 4:
        h.update(getattr(v, "__qualname__", "?").encode())
        _hash_code_object(h, code)
        for cell in getattr(v, "__closure__", None) or ():
            try:
                _fp_value(h, cell.cell_contents, depth + 1)
            except ValueError:
                h.update(b"<empty-cell>")
        for d in getattr(v, "__defaults__", None) or ():
            _fp_value(h, d, depth + 1)
        return
    try:
        r = repr(v)
    except Exception:
        r = type(v).__name__
    if " at 0x" in r:
        r = type(v).__name__
    h.update(r.encode())


def _reduce_fingerprint(reduce_fn):
    """Which reduction wrote a checkpoint: the function's qualname plus a
    recursive hash of its bytecode, constants, defaults and closure-cell
    contents (two reductions differing only in a captured value or a
    captured function do not collide); the repr for a callable without
    ``__code__``."""
    if reduce_fn is None:
        return None
    code = getattr(reduce_fn, "__code__", None)
    if code is not None:
        h = hashlib.sha256()
        _hash_code_object(h, code)
        for cell in getattr(reduce_fn, "__closure__", None) or ():
            try:
                _fp_value(h, cell.cell_contents)
            except ValueError:
                h.update(b"<empty-cell>")
        for d in getattr(reduce_fn, "__defaults__", None) or ():
            _fp_value(h, d)
        return f"{getattr(reduce_fn, '__qualname__', '?')}:{h.hexdigest()[:16]}"
    return repr(reduce_fn)


def _sweep_manifest(args_batch, extent, shape, chunk_size, engine, reduce_fn, kind,
                    precision, accuracy):
    """Fingerprint of everything that shapes the chunks' contents."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(args_batch, dtype=np.float64).tobytes())
    meta = {
        "extent": [float(v) for v in extent],
        "shape": [int(v) for v in shape],
        "chunk_size": int(chunk_size),
        "engine": engine,
        "reduced": _reduce_fingerprint(reduce_fn),
        "kind": kind,
        "precision": precision,
    }
    if kind == "flag_quantum_dif":
        meta["accuracy"] = float(accuracy)
    h.update(json.dumps(meta, sort_keys=True).encode())
    return {"sha256": h.hexdigest(), **meta}


@annotate("inflx.sweep.write")
def _atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save through a temp file and a rename, so a kill during the write
    never leaves a truncated ``chunk_*.npy`` (an absent chunk is recomputed
    on resume; a temp file a kill leaves is removed by the next run)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise


def _open_checkpoint(checkpoint_dir, manifest):
    """Create the directory and its manifest, or check the manifest found
    there; remove the temp files a killed run left."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    mpath = os.path.join(checkpoint_dir, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            found = json.load(f)
        if found.get("sha256") != manifest["sha256"]:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir!r} was written by a different sweep "
                "(args/extent/shape/chunk_size/engine/reduce/kind/precision mismatch) "
                "— refusing to resume; use a fresh directory or delete the stale "
                "checkpoints"
            )
    else:
        with open(mpath, "w") as f:
            json.dump(manifest, f)
    for stale in glob.glob(os.path.join(checkpoint_dir, "chunk_*.npy.tmp.*")):
        os.unlink(stale)


def _checked(reduce_fn):
    def single(maps):
        out = reduce_fn(maps)
        if isinstance(out, (tuple, list, dict)):
            raise TypeError(
                "reduce_fn must return a single array — the chunk/checkpoint "
                "plumbing (np.save, concatenation) cannot represent tuple/dict "
                "returns; stack multiple quantities into one tensor instead"
            )
        return out

    return single


def _check_kind(kind):
    if kind not in _SWEEP_KINDS:
        raise ValueError(f"unknown scan kind {kind!r}; expected one of {_SWEEP_KINDS}")


def sharded_scan(
    condition,
    args,
    extent,
    shape,
    mesh,
    grid_axis: str = "grid",
    dtype=None,
    engine: str | None = None,
    kind: str = "complete_analysis",
    accuracy: float = 1e-3,
    output: str = "f64_device",
    precision: str | None = None,
):
    """Any grid scan kind for one parameter set, the grid's rows split over
    ``mesh``'s ``grid_axis``.

    Each slot scans a contiguous block of N0 / n rows (the rows must divide
    evenly) in one launch of kernel B1, B2 or B4 by ``precision`` (the plain
    version on a CPU slot; ``engine`` resolves per slot as in
    :meth:`~inflatox_torch.consistency_conditions.GeneralisedAL.complete_analysis`),
    with the whole grid's coordinates, so the result is bit for bit the
    unsharded scan.  ``condition`` carries the model; the mesh decides the
    devices.

    ``kind``: any of the JAX package's sweep kinds.  ``"flag_quantum_dif"``
    thresholds the gradient maps with ``accuracy`` (|∂_a V| ≤ accuracy for
    every field): a (1, N0, N1) boolean tensor.

    ``output``: ``"f64_device"`` (default) — the (n_out, N0, N1) tensor on
    the mesh's first device (float32 for ``precision="f32"``); ``"pair"`` —
    per output a ``(hi, lo)`` pair of float32 tensors there; ``"f64"`` —
    numpy float64 (n_out, N0, N1), each slot's rows copied straight into
    their slice of one pinned host buffer (the array keeps it; torch's
    caching host allocator reuses it once the array is dropped).  ``"pair"`` and ``"f64"`` need precision ``"f64"``
    or ``"dd"`` and a numeric kind, as the JAX package's need a compensated
    engine.

    n_out: 6 for complete_analysis, 4 for hesse, 2 for gradient, 1
    otherwise.
    """
    _check_kind(kind)
    if output not in ("f64", "pair", "f64_device"):
        raise ValueError(f"output must be 'f64', 'pair' or 'f64_device', got {output!r}")
    precision = resolve_precision(precision, dtype)
    if output != "f64_device" and (precision == "f32" or kind == "flag_quantum_dif"):
        raise ValueError(
            f'output={output!r} requires precision "f64" or "dd" (the JAX package\'s '
            "compensated engines) and a numeric scan kind; this precision/kind returns "
            "the default device tensor only"
        )
    check_mesh(mesh)
    if kind == "flag_quantum_dif":
        grads = sharded_scan(condition, args, extent, shape, mesh, grid_axis=grid_axis,
                             engine=engine, kind="gradient", precision=precision)
        return (grads.abs() <= float(accuracy)).all(dim=0, keepdim=True)
    condition._validate_2field()
    args = condition._validate_args(args)
    slots = mesh.axis_slots(grid_axis)
    n_dev = len(slots)
    n0, n1 = int(shape[0]), int(shape[1])
    if n0 % n_dev != 0:
        raise ValueError(
            f"grid rows ({n0}) must be divisible by mesh axis '{grid_axis}' size ({n_dev})"
        )
    local = n0 // n_dev
    kernel = f"kernel {PRECISIONS[precision].grid_kernel}"
    model = condition.artifact

    def launch(i, device):
        scan = scan_cuda if resolve_engine(engine, device, kernel) == "cuda" else scan_torch
        return (scan(model, kind, args, extent, (n0, n1), device, precision,
                     rows=(i * local, local)),)

    host = output == "f64"
    (out,) = gather_shards(mesh, launch_shards(mesh, slots, launch, host, dim=1))
    if output == "pair":
        hi = out.float()
        lo = (out - hi.double()).float()
        return tuple((hi[k], lo[k]) for k in range(out.shape[0]))
    return out


def sharded_scan_ot(
    condition,
    args,
    x,
    mesh,
    grid_axis: str = "grid",
    dtype=None,
    engine: str | None = None,
    kind: str = "complete_analysis",
    accuracy: float = 1e-3,
    precision: str | None = None,
):
    """Any scan kind at the points of an (n, 2) trajectory (a numpy array,
    or a float64 tensor on any device), the points split evenly over ``mesh``'s
    ``grid_axis`` (padded by repeating the last point, trimmed on return).

    The four analysis kinds are one launch of kernel B5a
    (``precision="f64"``) or B5b (``"dd"``) a slot (the plain version on a
    CPU slot; ``engine`` resolves per slot).  The raw surfaces
    (``potential``, ``hesse``, ``gradient``) have no point kernel, as the
    JAX package's compensated engines have none: they run the torch
    evaluation of the model on each slot's device
    (:func:`~inflatox_torch.ops.cuda_kernels.evaluate_points`), as its XLA
    branch does.  ``kind="flag_quantum_dif"`` thresholds the gradient with
    ``accuracy`` ((1, n) boolean).  Each point carries its coordinates, so
    the result is bit for bit the unsharded evaluation.  Returns the (n_out,
    n) tensor on the mesh's first device."""
    _check_kind(kind)
    check_mesh(mesh)
    precision = resolve_precision(precision, dtype)
    kernel = PRECISIONS[precision].point_kernel
    if kernel is None:
        raise ValueError('the point scans take precision None, "f64" or "dd" (the JAX '
                         "package offers no f32 engine on trajectories)")
    if kind == "flag_quantum_dif":
        grads = sharded_scan_ot(condition, args, x, mesh, grid_axis=grid_axis,
                                engine=engine, kind="gradient", precision=precision)
        return (grads.abs() <= float(accuracy)).all(dim=0, keepdim=True)
    condition._validate_2field()
    args = condition._validate_args(args)
    x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x, dtype=np.float64))
    if x.dtype != torch.float64:
        raise TypeError(f"x must hold float64 values, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 2:
        raise ValueError("x must be an (n, 2) trajectory array")
    n = x.shape[0]
    slots = mesh.axis_slots(grid_axis)
    n_dev = len(slots)
    n_loc = -(-n // n_dev)
    pad = n_dev * n_loc - n
    xp = torch.cat([x, x[-1:].expand(pad, 2)]) if pad else x
    model = condition.artifact

    def launch(i, device):
        pts = xp[i * n_loc:(i + 1) * n_loc].to(device)
        if kind in POINT_KINDS:
            eng = resolve_engine(engine, device, f"kernel {kernel}")
            scan = scan_points_cuda if eng == "cuda" else scan_points_torch
            return (scan(model, kind, args, pts, precision),)
        xs = (pts[:, 0], pts[:, 1])
        if precision == "dd":
            xs = tuple(DD(c, torch.zeros_like(c)) for c in xs)
        return (evaluate_points(model, kind, args, xs, precision),)

    (out,) = gather_shards(mesh, launch_shards(mesh, slots, launch, False, dim=1))
    return out[:, :n]


def parameter_sweep(
    condition,
    args_batch,
    extent,
    shape,
    mesh=None,
    sweep_axis: str = "sweep",
    chunk_size: int | None = None,
    checkpoint_dir: str | None = None,
    progress: bool = True,
    dtype=None,
    reduce_fn=None,
    engine: str | None = None,
    kind: str = "complete_analysis",
    accuracy: float = 1e-3,
    precision: str | None = None,
):
    """Any grid scan kind over a batch of parameter sets, on the device of
    ``condition`` or over a mesh.

    Args
    ----
    condition: a :class:`~inflatox_torch.consistency_conditions.GeneralisedAL`
        of a 2-field model; its ``device`` is where the sweep runs without
        a mesh.
    args_batch: (S, k) array of parameter sets.
    extent: (x0_start, x0_stop, x1_start, x1_stop).
    shape: (N0, N1) grid resolution per parameter set.
    mesh, sweep_axis: a :func:`~inflatox_torch.parallel.make_mesh` mesh:
        each chunk is padded to a multiple of the ``sweep_axis`` size (the
        last set repeated) and split, one batched launch a slot, each slot's
        ``reduce_fn`` on its own device; the mesh decides the devices.
        Every set is bit for bit the unsharded sweep's.
    chunk_size: sets per launch (bounds device memory for large S and
        enables checkpointing).  Default: the whole batch in one launch.
    checkpoint_dir: if set, each chunk's result is written to
        ``chunk_{i:06d}.npy`` and existing files are loaded on resume, not
        recomputed.  A ``manifest.json`` fingerprints the inputs; resuming
        with different inputs raises ``ValueError``.  Writes are atomic
        (temp + rename) and run on a writer thread, overlapped with the next
        chunk's device work; a failed write raises at the end.
    reduce_fn: optional ``(n_out, N0, N1) → tensor`` in torch operations,
        applied per parameter set on the device as
        ``torch.func.vmap(reduce_fn)`` (e.g. ``lambda m: torch.stack([m[0].min(),
        m[0].argmax().to(m.dtype)])``).  It must return a single tensor:
        tuple, list or dict returns raise ``TypeError``.
    engine: None (``"cuda"`` on a CUDA device, ``"torch"`` on a CPU
        device; per slot with a mesh), ``"cuda"`` (kernel B7a, B7b or B7d by
        ``precision``) or ``"torch"`` (the plain version).  The JAX
        package's engine names raise and name their counterparts.
    kind: any of the JAX package's sweep kinds.  ``"flag_quantum_dif"``
        scans the ``gradient`` kind and thresholds the maps on the device
        (|∂_a V| ≤ ``accuracy`` for every field) before any ``reduce_fn``,
        which then sees the (1, N0, N1) boolean mask.
    precision, dtype: ``"f64"`` (default), ``"f32"`` or ``"dd"``; ``dtype``
        is the JAX package's spelling (float32 means ``"f32"``).

    Returns the stacked results as numpy: an (S, n_out, N0, N1) array (float32
    for ``"f32"``, bool for ``"flag_quantum_dif"``), or the stacked
    ``reduce_fn`` outputs.
    """
    _check_kind(kind)
    precision = resolve_precision(precision, dtype)
    kernel = f"kernel {PRECISIONS[precision].batch_kernel}"
    if mesh is None:
        mesh = Mesh(np.array([condition.device], dtype=object), (sweep_axis,),
                    np.zeros(1, dtype=int), 0)
    check_mesh(mesh)
    slots = mesh.axis_slots(sweep_axis)
    n_dev = len(slots)
    engine_name = resolve_engine(engine, mesh.home, kernel)  # the manifest's
    condition._validate_2field()
    model = condition.artifact
    args_batch = np.asarray(args_batch, dtype=np.float64)
    if args_batch.ndim != 2 or args_batch.shape[0] == 0:
        raise ValueError("args_batch must be (S, n_parameters) with S >= 1")
    S = args_batch.shape[0]
    chunk_size = int(chunk_size or S)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be a positive number of sets, got {chunk_size}")
    n_chunks = -(-S // chunk_size)
    scan_kind = "gradient" if kind == "flag_quantum_dif" else kind
    reduce = None if reduce_fn is None else torch.func.vmap(_checked(reduce_fn))
    acc = float(accuracy)

    def run_chunk(part):
        """Launch a chunk, one batched scan a slot, each result staged to
        the host as it is launched."""
        local = -(-len(part) // n_dev)
        padded = pad_rows(part, local * n_dev)

        def launch(i, device):
            with annotate("inflx.sweep.launch"):
                eng = resolve_engine(engine, device, kernel)
                scan = scan_batch_cuda if eng == "cuda" else scan_batch_torch
                out = scan(model, scan_kind, padded[i * local:(i + 1) * local], extent, shape,
                           device, precision)
                if kind == "flag_quantum_dif":
                    out = (out.abs() <= acc).all(dim=1, keepdim=True)
            if reduce is not None:
                with annotate("inflx.sweep.reduce"):
                    out = reduce(out)
            return (out,)

        return launch_shards(mesh, slots, launch, True)

    present = [False] * n_chunks
    if checkpoint_dir:
        error = None
        if mesh.rank == 0:  # one process writes the directory
            try:
                _open_checkpoint(checkpoint_dir, _sweep_manifest(
                    args_batch, extent, shape, chunk_size, engine_name, reduce_fn, kind,
                    precision, acc))
            except ValueError as exc:
                error = str(exc)
            present = [os.path.exists(os.path.join(checkpoint_dir, f"chunk_{ci:06d}.npy"))
                       for ci in range(n_chunks)]
        error, present = agree(mesh, (error, present))
        if error is not None:
            raise ValueError(error)

    result = None  # (S, ...) numpy, allocated from the first chunk seen
    write_futs = []

    def store(lo, arr):
        nonlocal result
        with annotate("inflx.sweep.store"):
            if result is None:
                result = np.empty((S, *arr.shape[1:]), dtype=arr.dtype)
            result[lo:lo + len(arr)] = arr
        return result[lo:lo + len(arr)]

    def finish(lo, shards, n_keep, path, writer):
        (arr,) = gather_shards(mesh, shards)
        rows = store(lo, arr[:n_keep])
        if path and mesh.rank == 0:
            if write_futs:
                # at most one write queued: where writes are the slower side
                # the loop waits here instead of piling chunk results up
                write_futs[-1].result()
            write_futs.append(writer.submit(_atomic_save, path, rows))

    with Progress("Parameter sweep", enabled=progress) as prog, \
            ThreadPoolExecutor(max_workers=1) as writer:
        pending = None
        done = 0
        for ci in range(n_chunks):
            lo = ci * chunk_size
            part = args_batch[lo:lo + chunk_size]
            path = (os.path.join(checkpoint_dir, f"chunk_{ci:06d}.npy")
                    if checkpoint_dir else None)
            if present[ci]:
                loaded = np.load(path, allow_pickle=False)
                if len(loaded) != len(part):
                    raise ValueError(f"{path} holds {len(loaded)} sets, expected {len(part)}")
                store(lo, loaded)
                done += 1
                prog.tick(done, n_chunks)
                continue
            shards = run_chunk(part)  # launch, then enqueue the copies
            if pending is not None:
                finish(*pending, writer)
                done += 1
                prog.tick(done, n_chunks)
            pending = (lo, shards, len(part), path)
        if pending is not None:
            finish(*pending, writer)
            done += 1
            prog.tick(done, n_chunks)
        for fut in write_futs:
            fut.result()  # a failed write (disk full, ...) raises here
    return result
