"""The parameter sweep's chunk loop on the card: where its host time goes, and
its one-chunk-deep pipeline against other orders of copy and write.

    python scripts/probe_sweep_pipeline.py [--chunks N]

Needs one NVIDIA GPU and nvcc.  Hyperinflation, 512² per set, two forms:
the kill/resume rehearsal's (bench cfg5c: the (min, argmin) reduction of
consistency, chunks of 32 sets, N chunks, default 256) and bench cfg5's full
maps (32 masses, chunks of 8).  Each loop is timed on the host clock,
median of 3 after one warm-up, checkpointing into ``build/pipeline_probe/``
(emptied before each call):

* ``sweep``: ``parallel.parameter_sweep`` itself (chunk i's copy enqueued
  into pinned memory with an event before chunk i+1's launch, waited on
  after it; checkpoint writes on a one-worker thread); also uncheckpointed;
* ``event_unbounded``: the same without waiting for the previous write
  before queueing the next;
* ``cpu_order``: the JAX package's order, chunk i's ``.cpu()`` after chunk
  i+1's launch, writes on a one-worker thread;
* ``main_thread_write``: the event order, the write done by the loop itself
  after chunk i+1's launch;
* ``sweep, switch 50 us``: ``parameter_sweep`` with the interpreter's
  thread switch interval at 50 us instead of 5 ms.

Then one uncheckpointed rehearsal-form loop written out with host clocks
around each step (launch, reduction, copy, wait and store), and
``_atomic_save`` alone on the rehearsal's chunk files, and its file system
calls one by one (create and write, rename, stat, unlink).  Every loop's
result must equal ``parameter_sweep``'s.
"""

import argparse
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import inflatox_torch  # noqa: E402
from inflatox_torch.consistency_conditions import GeneralisedAL  # noqa: E402
from inflatox_torch.ops.cuda_kernels import scan_batch_cuda  # noqa: E402
from inflatox_torch.parallel import parameter_sweep  # noqa: E402
from inflatox_torch.parallel.sweep import _atomic_save  # noqa: E402

DOC_EXTENT = (0.5, 2.5, 0.25, 3.0)


def _stage(out):
    """A chunk's copy to the host, non-blocking into pinned memory behind an
    event on the current stream: (host tensor, event)."""
    with torch.cuda.device(out.device):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
    return host, event
N = 512
CKDIR = os.path.join(ROOT, "build", "pipeline_probe")


def min_and_argmin(maps):
    c = torch.where(torch.isnan(maps[0]), torch.inf, maps[0])
    return torch.stack([c.min(), c.argmin().to(c.dtype)])


def chunk_loop(al, batch, chunk, reduce_fn, order):
    """Checkpointed chunk loop: ``order`` "cpu" (``.cpu()`` of chunk i after
    chunk i+1's launch, writer thread), "event" (event order, writer thread,
    writes queued without bound) or "main" (event order, the write in this
    thread after chunk i+1's launch)."""
    reduce = None if reduce_fn is None else torch.func.vmap(reduce_fn)
    os.makedirs(CKDIR, exist_ok=True)
    outs = []
    with ThreadPoolExecutor(max_workers=1) as writer:
        futs = []

        def finish(ci, dev_or_staged):
            if order == "cpu":
                host = dev_or_staged.cpu().numpy()
            else:
                staged, event = dev_or_staged
                event.synchronize()
                host = staged.numpy().copy()
            path = os.path.join(CKDIR, f"chunk_{ci:06d}.npy")
            if order == "main":
                _atomic_save(path, host)
            else:
                futs.append(writer.submit(_atomic_save, path, host))
            outs.append(host)

        pending = None
        for ci in range(-(-len(batch) // chunk)):
            dev = scan_batch_cuda(al.artifact, "complete_analysis",
                                  batch[ci * chunk:(ci + 1) * chunk], DOC_EXTENT, (N, N),
                                  al.device)
            dev = dev if reduce is None else reduce(dev)
            item = dev if order == "cpu" else _stage(dev)
            if pending is not None:
                finish(*pending)
            pending = (ci, item)
        finish(*pending)
        for fut in futs:
            fut.result()
    return np.concatenate(outs)


def host_s(fn, repeats=3):
    times = []
    for _ in range(repeats + 1):
        shutil.rmtree(CKDIR, ignore_errors=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times[1:])[len(times[1:]) // 2]


def switched(fn, interval):
    def run():
        old = sys.getswitchinterval()
        sys.setswitchinterval(interval)
        try:
            return fn()
        finally:
            sys.setswitchinterval(old)

    return run


def breakdown(al, batch, chunk):
    """Host seconds per chunk of each step of an uncheckpointed loop."""
    reduce = torch.func.vmap(min_and_argmin)
    steps = {"launch": 0.0, "reduce": 0.0, "copy": 0.0, "wait+store": 0.0}
    result = np.empty((len(batch), 2))
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    pending = None
    n_chunks = -(-len(batch) // chunk)
    for ci in range(n_chunks + 1):
        if ci < n_chunks:
            t = time.perf_counter()
            dev = scan_batch_cuda(al.artifact, "complete_analysis",
                                  batch[ci * chunk:(ci + 1) * chunk], DOC_EXTENT, (N, N),
                                  al.device)
            t1 = time.perf_counter()
            red = reduce(dev)
            t2 = time.perf_counter()
            staged = _stage(red)
            t3 = time.perf_counter()
            steps["launch"] += t1 - t
            steps["reduce"] += t2 - t1
            steps["copy"] += t3 - t2
        if pending is not None:
            t = time.perf_counter()
            (lo, (host, event)) = pending
            event.synchronize()
            result[lo:lo + chunk] = host.numpy()
            steps["wait+store"] += time.perf_counter() - t
        pending = (ci * chunk, staged) if ci < n_chunks else None
    total = time.perf_counter() - t_all
    return {k: v / n_chunks * 1e3 for k, v in steps.items()}, total / n_chunks * 1e3, result


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunks", type=int, default=256)
    opts = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    model, _ = inflatox_torch.models.hyperinflation()
    al = GeneralisedAL(inflatox_torch.Compiler(model, silent=True).compile(), device="cuda",
                       validate_basis=False)
    forms = {
        "rehearsal": (np.linspace(0.5, 2.0, 32 * opts.chunks)[:, None], 32, min_and_argmin),
        "cfg5 full maps": (np.linspace(0.5, 2.0, 32)[:, None], 8, None),
    }
    for name, (batch, chunk, red) in forms.items():
        def sweep(ck=True, batch=batch, chunk=chunk, red=red):
            return parameter_sweep(al, batch, DOC_EXTENT, (N, N), chunk_size=chunk,
                                   progress=False, reduce_fn=red,
                                   checkpoint_dir=CKDIR if ck else None)

        want = sweep(ck=False)
        for order in ("cpu", "event", "main"):
            got = chunk_loop(al, batch, chunk, red, order)
            assert np.array_equal(got, want, equal_nan=True), order
        variants = {
            "sweep, uncheckpointed": lambda: sweep(ck=False),
            "sweep": sweep,
            "event_unbounded": lambda: chunk_loop(al, batch, chunk, red, "event"),
            "cpu_order": lambda: chunk_loop(al, batch, chunk, red, "cpu"),
            "main_thread_write": lambda: chunk_loop(al, batch, chunk, red, "main"),
            "sweep, switch 50 us": switched(sweep, 5e-5),
        }
        times = {v: host_s(fn) for v, fn in variants.items()}
        n_chunks = -(-len(batch) // chunk)
        print(f"{name} ({len(batch)} sets at {N}², chunks of {chunk}, {n_chunks} chunks) on "
              f"{card}, host clock, median of 3: " + "; ".join(
                  f"{v} {t:.4f} s ({t / n_chunks * 1e3:.3f} ms a chunk)" for v, t in times.items()))
    batch, chunk, _ = forms["rehearsal"]
    breakdown(al, batch[:8 * chunk], chunk)  # warm-up
    steps, per_chunk, result = breakdown(al, batch, chunk)
    assert np.array_equal(result, parameter_sweep(al, batch, DOC_EXTENT, (N, N), chunk_size=chunk,
                                                  progress=False, reduce_fn=min_and_argmin))
    print(f"rehearsal loop, uncheckpointed, host ms a chunk on {card}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in steps.items()) + f"; all {per_chunk:.4f}")
    shutil.rmtree(CKDIR, ignore_errors=True)
    os.makedirs(CKDIR)
    arr = result[:chunk]
    t = time.perf_counter()
    for ci in range(len(batch) // chunk):
        _atomic_save(os.path.join(CKDIR, f"chunk_{ci:06d}.npy"), arr)
    n_files = len(batch) // chunk
    print(f"_atomic_save alone, {arr.nbytes}-byte chunks on {card}: "
          f"{(time.perf_counter() - t) / n_files * 1e3:.4f} ms a file")
    calls = {"create+write+close": 0.0, "rename": 0.0, "stat": 0.0, "unlink": 0.0}
    for ci in range(n_files):
        path = os.path.join(CKDIR, f"calls_{ci:06d}.npy")
        t0 = time.perf_counter()
        with open(path + ".tmp", "wb") as f:
            np.save(f, arr)
        t1 = time.perf_counter()
        os.replace(path + ".tmp", path)
        t2 = time.perf_counter()
        os.path.exists(path + ".tmp")
        t3 = time.perf_counter()
        os.unlink(path)
        t4 = time.perf_counter()
        for key, dt in zip(calls, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            calls[key] += dt
    print(f"file system calls under {CKDIR} on {card}, ms each: " + ", ".join(
        f"{k} {v / n_files * 1e3:.4f}" for k, v in calls.items()))
    shutil.rmtree(CKDIR, ignore_errors=True)


if __name__ == "__main__":
    main()
