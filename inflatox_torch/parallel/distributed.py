"""Several processes: the ``torch.distributed`` process group.

The port of ``inflatox_tpu/parallel/distributed.py``.  A sharded call needs
no collective while it computes (grid rows, trajectories, parameter sets,
pivots and chains are independent), so "distributed" reduces to: start the
process group, build a mesh over every process's devices
(:func:`~inflatox_torch.parallel.make_mesh`), and let the sharded calls
place their work; each gathers its shards over the group at the end, so
every process returns the whole result.

The backend is gloo: the gathers move host arrays, and processes that share
one GPU (two ranks on ``cuda:0``) are refused by NCCL.

Typical launcher, one process per card (``torchrun --nproc-per-node 4``
sets the environment)::

    from inflatox_torch.parallel import distributed, make_mesh, sharded_scan

    distributed.initialize()          # a plain single process: left as it is
    mesh = make_mesh(("grid",), devices=[torch.device("cuda", local_rank)])
    maps = sharded_scan(al, args, extent, (4096, 4096), mesh, output="f64")
"""

from __future__ import annotations

import os

import torch

from ..utils.logging import log_info, log_warn

__all__ = ["initialize", "is_multi_host"]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Start the ``torch.distributed`` process group (gloo) when several
    processes run.

    ``coordinator_address`` (``"host:port"``, or a ``tcp://`` URL),
    ``num_processes`` and ``process_id`` default to torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  A plain
    single-process session is left as it is, and a second call does
    nothing.  A failing start is logged, not raised, as in the JAX
    package."""
    import torch.distributed as dist  # noqa: PLC0415

    if not dist.is_available() or dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        return  # a single process
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    try:
        dist.init_process_group("gloo", init_method=url, world_size=int(num_processes),
                                rank=int(process_id))
    except (RuntimeError, ValueError) as exc:
        log_warn(f"torch.distributed initialization skipped: {exc}")
        return
    log_info(f"torch.distributed initialized: process {dist.get_rank()}/"
             f"{dist.get_world_size()}, {torch.cuda.device_count()} CUDA device(s) here")


def is_multi_host() -> bool:
    """Whether a process group of more than one process is running."""
    import torch.distributed as dist  # noqa: PLC0415

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
