"""Parameter sweeps: any grid scan kind over a batch of parameter sets.

The port of ``parameter_sweep`` (``inflatox_tpu/parallel/sweep.py:488-782``)
on one CUDA device.  A chunk of the batch is one launch of a batched grid
scan kernel (:func:`~inflatox_torch.ops.cuda_kernels.scan_batch_cuda`:
B7a in f64, B7b in f32, B7d in double-double), whose output is the
(S, n_out, N0, N1) stack the JAX sweep returns; ``engine="torch"`` runs its
plain PyTorch version instead, on any device.  A ``reduce_fn`` runs on the
device as ``torch.func.vmap(reduce_fn)``, the counterpart of the JAX
package's ``jax.vmap(reduce_fn)``, so huge sweeps bring only the reductions
to the host.

Checkpointing, as in the JAX package: each chunk's result goes to
``chunk_{i:06d}.npy`` through temp file and rename on a one-worker writer
thread, ``manifest.json`` fingerprints the inputs (with the precision
always, and the accuracy of ``flag_quantum_dif``), a resume loads the chunks
that exist and refuses a directory written by a different sweep.  Not
ported: the two legacy manifest forms the JAX package still accepts
(``_manifest_matches``), which only directories written by its older
releases carry.

The chunk loop is one chunk deep: chunk i's copy to the host is enqueued
(non-blocking, into pinned memory) with an event right after its launch and
before chunk i+1's, and the host waits on that event only once chunk i+1 is
launched.  So the wait ends when chunk i's kernel and copy are done, and
chunk i's host work (the copy into the result, the checkpoint write)
overlaps chunk i+1's kernel.  A ``.cpu()`` issued after chunk i+1's launch
would wait for that kernel too, on the same stream.  At most one checkpoint
write is queued behind the one being written: where writes are the slower
side, the loop waits for the writer instead of piling chunk results up in
memory (with full maps in chunks of 8 that was also 1.48× faster on an
H100's host, PERF.md).
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

from ..ops.cuda_kernels import PRECISIONS, scan_batch_cuda, scan_batch_torch
from ..utils.devices import resolve_engine, resolve_precision
from ..utils.logging import Progress

__all__ = ["parameter_sweep"]

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


def _stage(out: torch.Tensor):
    """Start the copy of a chunk's result to the host: from a CUDA device
    non-blocking into pinned memory, followed by an event on the current
    stream; returns (host tensor, event or None)."""
    if out.device.type != "cuda":
        return out, None
    with torch.cuda.device(out.device):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
    return host, event


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
    ``condition``.

    Args
    ----
    condition: a :class:`~inflatox_torch.consistency_conditions.GeneralisedAL`
        of a 2-field model; its ``device`` is where the sweep runs.
    args_batch: (S, k) array of parameter sets.
    extent: (x0_start, x0_stop, x1_start, x1_stop).
    shape: (N0, N1) grid resolution per parameter set.
    mesh, sweep_axis: sharding over devices is not ported yet; a ``mesh``
        raises ``NotImplementedError`` (ROADMAP §A.7).
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
        device), ``"cuda"`` (kernel B7a, B7b or B7d by ``precision``) or
        ``"torch"`` (the plain version).  The JAX package's engine names
        raise and name their counterparts.
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
    if kind not in _SWEEP_KINDS:
        raise ValueError(f"unknown scan kind {kind!r}; expected one of {_SWEEP_KINDS}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (sharding a sweep over devices) is not ported yet: ROADMAP §A.7 "
            "brings it with torch.distributed"
        )
    precision = resolve_precision(precision, dtype)
    device = condition.device
    engine = resolve_engine(engine, device, f"kernel {PRECISIONS[precision].batch_kernel}")
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
    scan = scan_batch_cuda if engine == "cuda" else scan_batch_torch
    scan_kind = "gradient" if kind == "flag_quantum_dif" else kind
    reduce = None if reduce_fn is None else torch.func.vmap(_checked(reduce_fn))
    acc = float(accuracy)

    def run_chunk(part):
        out = scan(model, scan_kind, part, extent, shape, device, precision)
        if kind == "flag_quantum_dif":
            out = (out.abs() <= acc).all(dim=1, keepdim=True)
        return out if reduce is None else reduce(out)

    if checkpoint_dir:
        _open_checkpoint(checkpoint_dir, _sweep_manifest(
            args_batch, extent, shape, chunk_size, engine, reduce_fn, kind, precision, acc))

    result = None  # (S, ...) numpy, allocated from the first chunk seen
    write_futs = []

    def store(lo, arr):
        nonlocal result
        if result is None:
            result = np.empty((S, *arr.shape[1:]), dtype=arr.dtype)
        result[lo:lo + len(arr)] = arr
        return result[lo:lo + len(arr)]

    def finish(lo, host, event, path, writer):
        if event is not None:
            event.synchronize()
        rows = store(lo, host.numpy())
        if path:
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
            if path and os.path.exists(path):
                loaded = np.load(path, allow_pickle=False)
                if len(loaded) != len(part):
                    raise ValueError(f"{path} holds {len(loaded)} sets, expected {len(part)}")
                store(lo, loaded)
                done += 1
                prog.tick(done, n_chunks)
                continue
            staged = _stage(run_chunk(part))  # launch, then enqueue the copy
            if pending is not None:
                finish(*pending, writer)
                done += 1
                prog.tick(done, n_chunks)
            pending = (lo, *staged, path)
        if pending is not None:
            finish(*pending, writer)
            done += 1
            prog.tick(done, n_chunks)
        for fut in write_futs:
            fut.result()  # a failed write (disk full, ...) raises here
    return result
