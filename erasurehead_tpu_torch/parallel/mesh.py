"""The worker mesh: the W logical workers folded onto the processes of a group.

The port of erasurehead_tpu/parallel/mesh.py. The reference's parallelism is
a master + W workers as MPI ranks (SURVEY.md §2.2); the JAX package puts the
W logical workers on a 1-D ``jax.sharding.Mesh`` axis ("workers") and decodes
with a ``psum`` over it. Here one process drives one device
(parallel/backend.py), and a :class:`WorkerMesh` names the processes of the
worker axis: rank ``r`` of a group of D holds the slots of workers
``[r*W/D, (r+1)*W/D)`` (:meth:`WorkerMesh.slice`, the counterpart of the JAX
package's ``worker_sharding``), and the decode's ``psum`` is one
``all_reduce(SUM)`` (:meth:`WorkerMesh.all_reduce`).

Every rank is a replica of the master: it draws the same arrivals from the
same seeds, builds the same collection and decode weights on the host, and
applies the same update to the same all-reduced gradient, so every rank ends
with the same params, bitwise.

**Ranks outside the worker group.** When W has no divisor equal to the world
size, the group is a prefix of the world (the JAX package's ``worker_mesh(n)``
trims to a prefix of the devices). The other ranks hold no slots, contribute
exact zeros to the world all-reduce and apply the same update: they stay
replicas with no sub-group and no broadcast.

Without a process group the mesh has world size 1, no collective runs, and a
run is exactly the one-device run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.parallel import backend as backend_lib

WORKER_AXIS = "workers"
# the tensor-parallel axis of the JAX package's MLP family (its 2-D meshes)
MODEL_AXIS = "model"

#: the ROADMAP item that brings the model-internal axes and the 2-D meshes,
#: streamed windows across ranks, one process driving several devices, and
#: the drivers layered over train() at world sizes above 1
A9B = "ROADMAP A9b"


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """The processes of the worker axis, as seen from one of them.

    ``ranks`` are the world ranks of the worker group (a prefix of the
    world), ``rank`` this process's world rank, ``world`` the world size,
    ``device`` the device the group was formed for (None without a group),
    ``distributed`` whether a process group exists (then every decode
    all-reduces, even at world size 1), ``backend`` its backend."""

    ranks: tuple
    rank: int = 0
    world: int = 1
    device: Optional[torch.device] = None
    distributed: bool = False
    backend: Optional[str] = None

    axis_names = (WORKER_AXIS,)

    @property
    def size(self) -> int:
        """Devices on the worker axis (D)."""
        return len(self.ranks)

    @property
    def shape(self) -> dict:
        return {WORKER_AXIS: self.size}

    @property
    def index(self) -> Optional[int]:
        """This process's position on the worker axis, None outside it."""
        return self.ranks.index(self.rank) if self.rank in self.ranks else None

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    def slice(self, n: int) -> tuple:
        """This rank's ``[lo, hi)`` of a length-``n`` axis split over the
        group (``n`` divisible by D: :func:`check_divisible`); ``(n, n)``,
        empty, outside the group."""
        if not self.member:
            return n, n
        per = n // self.size
        return self.index * per, (self.index + 1) * per

    # -- collectives ---------------------------------------------------------

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend moves: a host copy of a card tensor under
        gloo (gloo's point-to-point reads host memory), else ``t``. Values
        are moved, never transformed."""
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu()
        return t

    def all_reduce(self, tree):
        """Sum a tensor, or a tree of float32 tensors, over the world: the
        decode's ``psum``. One collective for the whole tree (its leaves
        concatenated). The identity without a process group."""
        if not self.distributed:
            return tree
        leaves, spec = pytree.tree_flatten(tree)
        flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
        wire = self._stage(flat)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM)
        if wire is not flat:
            flat = wire.to(flat.device)
        out, at = [], 0
        for leaf in leaves:
            out.append(flat[at:at + leaf.numel()].view(leaf.shape))
            at += leaf.numel()
        return pytree.tree_unflatten(out, spec)

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (same shape and dtype on all), in world rank
        order, on ``t``'s device."""
        if not self.distributed:
            return [t]
        wire = self._stage(t.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        return [p.to(t.device) for p in parts]

    def ring_shift(self, block):
        """Start one ring hop of a tree of tensors: send it to the previous
        position on the worker axis and receive the next position's (device
        d receives device d+1's block, the direction the cyclic codes'
        w..w+s supports point). Returns a callable that waits and gives the
        received tree on the block's device."""
        leaves, spec = pytree.tree_flatten(block)
        D, i = self.size, self.index
        prev, nxt = self.ranks[(i - 1) % D], self.ranks[(i + 1) % D]
        sent = [self._stage(leaf.contiguous()) for leaf in leaves]
        got = [torch.empty_like(s) for s in sent]
        ops = [dist.P2POp(dist.isend, s, prev) for s in sent]
        ops += [dist.P2POp(dist.irecv, g, nxt) for g in got]
        works = dist.batch_isend_irecv(ops)

        def wait():
            for w in works:
                w.wait()
            del sent[:]  # the sends are done with their buffers
            return pytree.tree_unflatten(
                [g.to(leaf.device) for g, leaf in zip(got, leaves)], spec
            )

        return wait


def worker_mesh(n_devices: Optional[int] = None) -> WorkerMesh:
    """The 1-D worker mesh over the first ``n_devices`` processes of the
    world (all of them by default), ring-aligned (:func:`ring_order_devices`).
    Without a process group the world is this one process."""
    world = backend_lib.world_size()
    if n_devices is None:
        n_devices = world
    if n_devices < 1:
        raise ValueError(f"asked for {n_devices} devices")
    if n_devices > world:
        raise ValueError(f"asked for {n_devices} devices, have {world}")
    distributed = dist.is_initialized()
    return WorkerMesh(
        ranks=tuple(ring_order_devices(range(n_devices))),
        rank=dist.get_rank() if distributed else 0,
        world=world,
        device=backend_lib.group_device(),
        distributed=distributed,
        backend=dist.get_backend() if distributed else None,
    )


def auto_mesh(need: int) -> WorkerMesh:
    """The largest worker group whose size divides the sharded axis length
    ``need`` (the reference ran W workers on W nodes; here logical workers
    fold onto whatever processes exist: W = 30 over 4 processes uses 3)."""
    avail = backend_lib.world_size()
    return worker_mesh(max(d for d in range(1, avail + 1) if need % d == 0))


def ring_order_devices(devices: Sequence) -> list:
    """The order of the ring's positions. The JAX package walks TPU chip
    coordinates so that ring neighbours are ICI neighbours; CUDA devices
    and processes carry no chip coordinates, so the given order stands, as
    it does for the JAX package's CPU devices."""
    return list(devices)


def worker_plus_axis_mesh(axis_name: str, shards: int, workers_devices: int, devices=None):
    """The 2-D (workers, <axis>) mesh of a model-internal axis: not ported."""
    raise NotImplementedError(
        f"a 2-D (workers, {axis_name!r}) mesh with {shards} shards carries a "
        f"model-internal axis, which waits for {A9B} (the tp, pp, ep and "
        "seq axes)"
    )


def worker_seq_mesh(seq_shards: int, workers_devices: int, devices=None):
    """(workers, seq): sequence parallelism for the attention family."""
    return worker_plus_axis_mesh("seq", seq_shards, workers_devices, devices)


def worker_tp_mesh(tp_shards: int, workers_devices: int, devices=None):
    """(workers, model): tensor parallelism for the MLP family."""
    return worker_plus_axis_mesh(MODEL_AXIS, tp_shards, workers_devices, devices)


def axis_active(mesh, axis_name: str) -> bool:
    """Does this mesh carry a >1-sized ``axis_name`` axis?"""
    return axis_name in mesh.axis_names and mesh.shape[axis_name] > 1


def require_one_process(what: str, mesh=None) -> None:
    """Refuse a world of several processes on a path that runs in one, by
    name: ``what`` at world size above 1 waits for :data:`A9B`."""
    world = mesh.world if mesh is not None else backend_lib.world_size()
    if world > 1:
        raise ValueError(
            f"{what} runs in one process; at world size {world} it waits "
            f"for {A9B}"
        )


def check_divisible(n: int, mesh, what: str) -> None:
    """Refuse an axis that does not fold evenly onto the worker axis."""
    d = mesh.size
    if n % d:
        raise ValueError(
            f"{what}={n} must be divisible by the mesh's {d} worker-axis "
            f"devices; pick n_workers as a multiple of the device count"
        )
