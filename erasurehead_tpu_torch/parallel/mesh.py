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

**The 2-D meshes** (:func:`worker_plus_axis_mesh`, the JAX package's grid
``devs[:need].reshape(workers_devices, shards)``): world rank ``r`` of the
grid sits at worker position ``r // shards`` and axis position
``r % shards``. A model-internal axis (the attention family's ``seq``, the
mlp's tensor-parallel ``model``, the deepmlp's ``pipe``, the moe's
``expert``) runs within a row, the ranks that share a worker position: they
hold the same slots, and the model's collectives (:meth:`WorkerMesh.axis_psum`,
:meth:`~WorkerMesh.axis_shift`, :meth:`~WorkerMesh.axis_all_to_all`) run over
the row's process sub-group. The worker axis is the column, the ranks that
share an axis position: the ring transport's hops go along it. The decode's
psum over both axes is one all-reduce over the world (the JAX package's
explicit recipe sums every mesh axis), to which ranks outside the grid add
exact zeros, as on the 1-D mesh. The JAX package's ``shard_map`` axes thus
become process sub-groups, one per row, built by every rank of the world in
the same order (:func:`_row_groups`).

The model's collectives are ``torch.autograd.Function`` s, so one backward
pass through a sharded forward runs their transposes: a sum all-reduce's
cotangent is all-reduced (the JAX package's ``psum`` transposes to ``psum``),
a one-hop shift sends its cotangent back the other way (``ppermute``
transposes to the inverse permutation), an all-to-all's cotangent takes the
all-to-all with split and concat swapped. Every rank of a row builds the same
graph (the models select with ``torch.where``, never by skipping an op), so
the backward runs the collectives in the same order on every rank. Under
gloo a card tensor moves through a host copy (:meth:`WorkerMesh._stage`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.parallel import backend as backend_lib
from erasurehead_tpu_torch.utils.tracing import annotate

WORKER_AXIS = "workers"
# the tensor-parallel axis of the JAX package's MLP family (its 2-D meshes)
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """The processes of the mesh, as seen from one of them.

    ``ranks`` are the world ranks of the grid in row-major order (a prefix
    of the world): on the 1-D mesh, the worker group. ``rank`` is this
    process's world rank, ``world`` the world size, ``device`` the device the
    group was formed for (None without a group), ``distributed`` whether a
    process group exists (then every decode all-reduces, even at world size
    1), ``backend`` its backend. A 2-D mesh names its model-internal axis
    (``axis_name``, ``shards`` ranks a row) and holds this rank's row
    sub-group (``axis_group``; None off the grid or at one shard)."""

    ranks: tuple
    rank: int = 0
    world: int = 1
    device: Optional[torch.device] = None
    distributed: bool = False
    backend: Optional[str] = None
    axis_name: Optional[str] = None
    shards: int = 1
    axis_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def axis_names(self) -> tuple:
        if self.axis_name is None:
            return (WORKER_AXIS,)
        return (WORKER_AXIS, self.axis_name)

    @property
    def size(self) -> int:
        """Devices on the worker axis (D)."""
        return len(self.ranks) // self.shards

    @property
    def shape(self) -> dict:
        if self.axis_name is None:
            return {WORKER_AXIS: self.size}
        return {WORKER_AXIS: self.size, self.axis_name: self.shards}

    @property
    def _position(self) -> Optional[int]:
        return self.ranks.index(self.rank) if self.rank in self.ranks else None

    @property
    def index(self) -> Optional[int]:
        """This process's position on the worker axis, None outside it."""
        pos = self._position
        return None if pos is None else pos // self.shards

    @property
    def axis_index(self) -> Optional[int]:
        """This process's position on the model-internal axis (0 on the 1-D
        mesh), None outside the grid."""
        pos = self._position
        return None if pos is None else pos % self.shards

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    def column(self) -> tuple:
        """The world ranks of this process's worker axis: the ranks that
        share its axis position (the whole group on the 1-D mesh)."""
        return self.ranks[self.axis_index::self.shards]

    def row(self) -> tuple:
        """The world ranks of this process's model-internal axis: the ranks
        that share its worker position."""
        i = self.index
        return self.ranks[i * self.shards:(i + 1) * self.shards]

    def slice(self, n: int) -> tuple:
        """This rank's ``[lo, hi)`` of a length-``n`` axis split over the
        worker axis (``n`` divisible by D: :func:`check_divisible`); ``(n,
        n)``, empty, outside the grid. The ranks of a row hold the same
        slice."""
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
        D, i, col = self.size, self.index, self.column()
        prev, nxt = col[(i - 1) % D], col[(i + 1) % D]
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

    # -- the model-internal axis: differentiable, over the row ---------------

    def axis_psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model-internal axis (the JAX package's
        ``lax.psum(t, axis)``), differentiably: the backward all-reduces the
        cotangent."""
        return _AxisPsum.apply(t, self)

    def axis_shift(self, t: torch.Tensor, cyclic: bool = True) -> torch.Tensor:
        """One hop along the model-internal axis, differentiably: position
        ``a`` sends ``t`` to ``a + 1`` and returns what ``a - 1`` sent (the
        JAX package's ``ppermute`` with ``[(i, i + 1)]``, mod the axis size
        when ``cyclic``; otherwise position 0 receives zeros and the last
        position sends nothing). The backward sends the cotangent the other
        way."""
        return _AxisShift.apply(t, self, cyclic)

    def axis_all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True)``
        over the model-internal axis, differentiably: ``t`` splits into
        ``shards`` chunks along ``split_dim``, chunk j goes to position j,
        and the chunks received concatenate along ``concat_dim`` in position
        order. The backward is the all-to-all with the two dims swapped."""
        return _AxisAllToAll.apply(t, self, split_dim, concat_dim)

    def _back(self, wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return wire if wire.device == like.device else wire.to(like.device)

    # the axis collectives name their regions (``eh_axis/*``) for a
    # --trace-dir trace, forward and backward alike

    def _axis_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        with annotate("eh_axis/psum"):
            wire = self._stage(t.contiguous())
            if wire is t:  # the collective writes in place: never into the input
                wire = t.clone()
            dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.axis_group)
            return self._back(wire, t)

    def _axis_hop(self, t: torch.Tensor, step: int, cyclic: bool) -> torch.Tensor:
        """Send ``t`` to axis position ``a + step`` and receive from
        ``a - step`` (``step`` is +1 or -1); without ``cyclic`` the ends
        send or receive nothing and receive zeros."""
        row, a, p = self.row(), self.axis_index, self.shards
        dst, src = a + step, a - step
        with annotate("eh_axis/shift"):
            wire = self._stage(t.contiguous())
            got = torch.zeros_like(wire)
            ops = []
            if cyclic or 0 <= dst < p:
                ops.append(dist.P2POp(dist.isend, wire, row[dst % p]))
            if cyclic or 0 <= src < p:
                ops.append(dist.P2POp(dist.irecv, got, row[src % p]))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            return self._back(got, t)

    def _axis_exchange(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        with annotate("eh_axis/all_to_all"):
            chunks = torch.stack(t.chunk(self.shards, dim=split_dim))  # [p, ...]
            wire = self._stage(chunks.contiguous())
            got = torch.empty_like(wire)
            dist.all_to_all_single(got, wire, group=self.axis_group)
            return torch.cat(self._back(got, t).unbind(0), dim=concat_dim)


class _AxisPsum(torch.autograd.Function):
    """psum over the row; its transpose is the psum of the cotangent."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh._axis_all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._axis_all_reduce(g), None


class _AxisShift(torch.autograd.Function):
    """One hop a -> a+1 along the row; its transpose is the hop a+1 -> a."""

    @staticmethod
    def forward(ctx, t, mesh, cyclic):
        ctx.mesh, ctx.cyclic = mesh, cyclic
        return mesh._axis_hop(t, 1, cyclic)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._axis_hop(g, -1, ctx.cyclic), None, None


class _AxisAllToAll(torch.autograd.Function):
    """The tiled all-to-all over the row; its transpose swaps the dims."""

    @staticmethod
    def forward(ctx, t, mesh, split_dim, concat_dim):
        ctx.mesh, ctx.dims = mesh, (split_dim, concat_dim)
        return mesh._axis_exchange(t, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.mesh._axis_exchange(g, concat_dim, split_dim), None, None, None


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


# the row sub-groups built so far, by (world group, grid ranks, shards):
# every rank must build every group of the world in the same order, once
_ROW_GROUPS: dict = {}


def _row_groups(ranks: tuple, shards: int) -> list:
    """One process sub-group per row of the grid ``ranks`` (row-major,
    ``shards`` a row), built once per process group. ``dist.new_group`` is
    called by every rank of the world, for every row, in row order, as it
    must be; a rank outside a row gets a non-member handle for it."""
    key = (id(dist.group.WORLD), ranks, shards)
    groups = _ROW_GROUPS.get(key)
    if groups is None:
        groups = [dist.new_group(list(ranks[i:i + shards]))
                  for i in range(0, len(ranks), shards)]
        _ROW_GROUPS[key] = groups
    return groups


def worker_plus_axis_mesh(
    axis_name: str, shards: int, workers_devices: int,
    devices: Optional[Sequence] = None,
) -> WorkerMesh:
    """The 2-D (workers, <axis>) mesh: the coded-DP worker axis composed
    with a model-internal axis of ``shards`` processes a row, over the first
    ``workers_devices * shards`` world ranks (``devices``, world ranks, to
    pick others). The stack shards over the worker axis and replicates over
    the row; the model splits its own internal dimension over the row."""
    world = backend_lib.world_size()
    devs = list(devices if devices is not None else range(world))
    need = workers_devices * shards
    if need > len(devs):
        raise ValueError(
            f"mesh {workers_devices}x{shards} needs {need} devices, "
            f"have {len(devs)}"
        )
    ranks = tuple(devs[:need])
    distributed = dist.is_initialized()
    rank = dist.get_rank() if distributed else 0
    group = None
    if distributed and shards > 1:
        groups = _row_groups(ranks, shards)
        if rank in ranks:
            group = groups[ranks.index(rank) // shards]
    return WorkerMesh(
        ranks=ranks,
        rank=rank,
        world=world,
        device=backend_lib.group_device(),
        distributed=distributed,
        backend=dist.get_backend() if distributed else None,
        axis_name=axis_name,
        shards=shards,
        axis_group=group,
    )


def worker_seq_mesh(seq_shards: int, workers_devices: int, devices=None) -> WorkerMesh:
    """(workers, seq): sequence parallelism for the attention family
    (parallel/ring.py's axis; models/attention._predict_seq)."""
    from erasurehead_tpu_torch.parallel.ring import SEQ_AXIS

    return worker_plus_axis_mesh(SEQ_AXIS, seq_shards, workers_devices, devices)


def worker_tp_mesh(tp_shards: int, workers_devices: int, devices=None) -> WorkerMesh:
    """(workers, model): tensor parallelism for the MLP family, hidden units
    split over the model axis (models/mlp._predict_tp)."""
    return worker_plus_axis_mesh(MODEL_AXIS, tp_shards, workers_devices, devices)


def axis_active(mesh, axis_name: str) -> bool:
    """Does this mesh carry a >1-sized ``axis_name`` axis? The single rule
    the model families' ``for_mesh`` hooks use to decide whether to swap in
    their model-parallel variant (no mesh carries none)."""
    if mesh is None:
        return False
    return axis_name in mesh.axis_names and mesh.shape[axis_name] > 1


def check_divisible(n: int, mesh, what: str) -> None:
    """Refuse an axis that does not fold evenly onto the worker axis (the
    model-internal axis replicates the data)."""
    d = mesh.size
    if n % d:
        raise ValueError(
            f"{what}={n} must be divisible by the mesh's {d} worker-axis "
            f"devices; pick n_workers as a multiple of the device count"
        )
