"""Device meshes, and how a sharded call places its work on them.

The port of ``inflatox_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a ``jax.sharding.Mesh``; its sharded calls need no
collective, because the work is independent by grid rows, trajectories,
parameter sets, pivots and chains.  Here a :class:`Mesh` is an array of
slots, each a ``torch.device`` owned by one process:

* axis ``"grid"`` splits a grid's rows (:func:`~inflatox_torch.parallel.
  sharded_scan`) or a trajectory's points; axis ``"sweep"`` a parameter
  sweep's sets; the first axis, by default, a batch of background solves and
  the pivots of the spectra; the chains of a posterior take every slot;
* the same device may fill several slots (four slots on ``cuda:0`` run as
  four launches of a quarter of the work each);
* once ``torch.distributed`` has a process group
  (:func:`~inflatox_torch.parallel.distributed.initialize`),
  :func:`make_mesh` lays the mesh over every process's devices in rank
  order, each process passing the same number.  Each process launches the
  shards of the slots it owns, and the results are gathered over the group
  (gloo, on host arrays), so every process returns the whole result.

A sharded call launches every shard it owns, each on its slot's device,
before it waits for any: a result for the host is copied per shard into its
slice of one pinned host buffer behind an event, a result left on the
device is assembled on the mesh's first device of this process
(``home``).  Each
slot's engine resolves by its own device (a CUDA slot runs the kernel, a
CPU slot the plain version); nothing moves to the CPU.  Spans
(``utils.profiling``): ``inflx.shards.stage``, a shard's copies to the host
and their event; ``inflx.shards.wait``, the wait for them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils.profiling import annotate

__all__ = ["Mesh", "make_mesh", "default_mesh"]


class Mesh:
    """Slots in a named grid: ``devices`` (a numpy object array of
    ``torch.device`` in the mesh's shape), ``ranks`` (the process that owns
    each slot, the same shape), ``axis_names``, ``shape`` (axis name →
    size, so ``mesh.shape[axis]`` reads as in the JAX package) and
    ``size``.  Build one with :func:`make_mesh` or :func:`default_mesh`."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, ranks: np.ndarray, rank: int):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.rank = rank
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        own = [d for d, r in zip(devices.flat, ranks.flat) if r == rank]
        if not own:
            raise ValueError(f"process {rank} owns no slot of the mesh")
        #: the first device of this process's slots: device results land here
        self.home = own[0]

    @property
    def multi_process(self) -> bool:
        return bool((self.ranks != self.rank).any())

    def __repr__(self):
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}, "
                f"devices={[str(d) for d in self.devices.flat]})")

    def axis_slots(self, axis: str) -> list:
        """The ``(device, rank)`` of each index along ``axis``, at index 0 of
        every other axis (a shard along one axis is computed once, where
        the JAX package replicates it over the others)."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no axis {axis!r}; its axes are {self.axis_names}")
        a = self.axis_names.index(axis)
        n = self.shape[axis]
        devices = np.moveaxis(self.devices, a, 0).reshape(n, -1)[:, 0]
        ranks = np.moveaxis(self.ranks, a, 0).reshape(n, -1)[:, 0]
        return list(zip(devices, (int(r) for r in ranks)))

    def all_slots(self) -> list:
        """The ``(device, rank)`` of every slot, in the mesh's order."""
        return list(zip(self.devices.flat, (int(r) for r in self.ranks.flat)))


def _process_group():
    """(rank, world size) of the ``torch.distributed`` process group, or
    (0, 1) without one."""
    import torch.distributed as dist  # noqa: PLC0415

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(axis_names: tuple = ("sweep", "grid"), shape: tuple | None = None,
              devices=None) -> Mesh:
    """Build a mesh over ``devices`` (default: this process's CUDA devices;
    the same device may be given several times, e.g. ``[torch.device("cpu")]
    * 8``).  With a ``torch.distributed`` process group the mesh spans every
    process's devices in rank order (each process passes as many), and
    every process must call this together.

    With ``shape=None`` all devices lie on the last axis (grid tiling), size
    1 for the leading axes.  A host without CUDA and without ``devices``
    raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(devices=None) lays the mesh over this process's CUDA devices, "
                "and CUDA is not available on this host; pass devices=, e.g. "
                "[torch.device(\"cpu\")] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    rank, world = _process_group()
    if world > 1:
        import torch.distributed as dist  # noqa: PLC0415

        gathered = [None] * world
        dist.all_gather_object(gathered, [str(d) for d in local])
        if len({len(g) for g in gathered}) != 1:
            raise ValueError(
                f"every process must give make_mesh as many devices: {[len(g) for g in gathered]}"
            )
        flat = [torch.device(d) for g in gathered for d in g]
        owners = [r for r, g in enumerate(gathered) for _ in g]
    else:
        flat, owners = local, [0] * len(local)
    n = len(flat)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match device count {n}")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names {axis_names}")
    array = np.empty(n, dtype=object)
    array[:] = flat
    return Mesh(array.reshape(shape), axis_names, np.asarray(owners).reshape(shape), rank)


def default_mesh(devices=None) -> Mesh:
    """1-D ``("grid",)`` mesh over all devices: the right default for
    single-model grid scans."""
    return make_mesh(axis_names=("grid",), shape=None, devices=devices)


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`; anything else raises TypeError."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh= takes a Mesh built by inflatox_torch.parallel.make_mesh (or default_mesh), "
            f"got {type(mesh).__name__}"
        )
    return mesh


def check_mesh_device(mesh, device) -> Mesh:
    """``mesh`` (checked), whose devices decide where a call runs: a
    ``device=`` of another device type raises."""
    check_mesh(mesh)
    kind = torch.device(device).type
    other = sorted({str(d) for d in mesh.devices.flat if d.type != kind})
    if other:
        raise ValueError(
            f"mesh= decides the devices, and this mesh has {other}, which device={str(device)!r} "
            f"does not name; pass the mesh's device type as device="
        )
    return mesh


def on_device(device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _pieces(full: torch.Tensor, dim: int, i: int, size: int) -> list:
    """Shard ``i``'s slice (``size`` along ``dim``) of a contiguous ``full``
    as contiguous pieces: the slice itself for dim 0, else one piece for
    each index of the leading dims (a plane of a map)."""
    part = full.narrow(dim, i * size, size)
    return [part[idx] for idx in np.ndindex(*part.shape[:dim])]


class _HostJoin:
    """The shards' parts joined along ``dim`` in one host buffer a part
    (pinned when the shards lie on a CUDA device): each shard's part is
    copied into its slice as soon as it is launched, from a CUDA device
    without blocking and behind an event, so the join costs the copies to
    the host and nothing after them."""

    def __init__(self, n: int, dim: int):
        self.n, self.dim = n, dim
        self.full = None  # one buffer a part, from the first shard's shapes
        self.metas = {}  # shard → [(shape, dtype name)] of its parts
        self.events = []

    def buffers(self, meta, pin: bool) -> list:
        if self.full is None:
            self.full = []
            for shape, dtype in meta:
                joined = list(shape)
                joined[self.dim] *= self.n
                self.full.append(torch.empty(joined, dtype=getattr(torch, dtype),
                                             pin_memory=pin))
        return self.full

    @annotate("inflx.shards.stage")
    def put(self, i: int, parts: tuple) -> None:
        device = parts[0].device
        meta = [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in parts]
        self.metas[i] = meta
        cuda = device.type == "cuda"
        for full, t in zip(self.buffers(meta, cuda), parts):
            size = t.shape[self.dim]
            sources = [t[idx] for idx in np.ndindex(*t.shape[:self.dim])]
            for piece, src in zip(_pieces(full, self.dim, i, size), sources):
                piece.copy_(src, non_blocking=cuda)
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self.events.append(event)

    def wait(self) -> None:
        for event in self.events:
            event.synchronize()
        self.events = []


def launch_shards(mesh: Mesh, slots: list, launch, host: bool, dim: int = 0):
    """``launch(i, device)`` (a tuple of tensors on ``device``) for every
    slot ``i`` of ``slots`` that this process owns, each under its device,
    all launched before any wait.  With ``host`` (and with several
    processes) each result is copied to its slice of the host result as it
    is launched (:class:`_HostJoin`).  :func:`gather_shards` takes what
    this returns."""
    join = _HostJoin(len(slots), dim) if host or mesh.multi_process else None
    own = {}
    for i, (device, rank) in enumerate(slots):
        if rank != mesh.rank:
            continue
        with on_device(device):
            parts = launch(i, device)
            if join is None:
                own[i] = parts
            else:
                join.put(i, parts)
    return {"join": join, "own": own, "n": len(slots), "host": host, "dim": dim}


def _exchange(mesh: Mesh, join: _HostJoin) -> None:
    """Fill the slices of the shards other processes own: each piece of each
    shard broadcast over the process group from its owner (as raw bytes, so
    any dtype passes gloo), straight into its slice."""
    import torch.distributed as dist  # noqa: PLC0415

    metas = [None] * dist.get_world_size()
    dist.all_gather_object(metas, join.metas)
    for owner, meta in enumerate(metas):
        for i in sorted(meta):
            for full, (shape, _) in zip(join.buffers(meta[i], False), meta[i]):
                for piece in _pieces(full, join.dim, i, shape[join.dim]):
                    dist.broadcast(piece.view(torch.uint8), src=owner)


def gather_shards(mesh: Mesh, launched: dict) -> tuple:
    """The shards of :func:`launch_shards` joined part by part along its
    ``dim``: numpy arrays (``host``) or tensors on ``mesh.home``."""
    join, n, dim = launched["join"], launched["n"], launched["dim"]
    if join is not None:
        with annotate("inflx.shards.wait"):
            join.wait()
        if mesh.multi_process:
            _exchange(mesh, join)
        if launched["host"]:
            return tuple(full.numpy() for full in join.full)
        return tuple(full.to(mesh.home) for full in join.full)
    every = [launched["own"][i] for i in range(n)]
    if n == 1:
        return tuple(t.to(mesh.home) for t in every[0])
    return tuple(torch.cat([s[k].to(mesh.home) for s in every], dim=dim)
                 for k in range(len(every[0])))


def agree(mesh: Mesh, value):
    """Process 0's ``value`` on every process (itself without a group)."""
    if not mesh.multi_process:
        return value
    import torch.distributed as dist  # noqa: PLC0415

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """A batch-leading array padded to ``rows`` rows by repeating its last
    row (the JAX package's ``_pad_batch``)."""
    pad = rows - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
