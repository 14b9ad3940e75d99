"""Distributed backend init: one process per device over ``torch.distributed``.

The port of erasurehead_tpu/parallel/backend.py. The reference's cluster is
mpirun + a hostfile + MPI4Py point-to-point (SURVEY.md §2.3); the JAX package
joins every host to one SPMD program with ``jax.distributed.initialize``.
Here each process drives one device, ``torchrun`` (or the caller) hands it
its rank, and the worker axis spans the processes (parallel/mesh.py): the
decode's ``psum`` becomes one ``all_reduce`` over the group.

One backend per run, chosen by the caller: ``nccl`` for ``cuda``, ``gloo``
for ``cpu``, or an explicit ``backend=``. A group that does not form raises:
nothing falls back from NCCL to gloo, or from the card to the CPU.

With no cluster environment and no arguments this is a no-op, so entry points
call it unconditionally at start; it is idempotent.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: torchrun's environment: the rank, the world size, the rank on this node,
#: and the rendezvous address
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

#: how long a collective may wait for a peer before it raises: a dead rank
#: must end its survivors' runs, not hang them
DEFAULT_TIMEOUT_S = 300.0

# the device this process's group was formed for (None: no group formed
# here); parallel/mesh.py builds its WorkerMesh on it
_device: Optional[torch.device] = None


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return None if val in (None, "") else int(val)


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    local_rank: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
    store=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Join (or skip) the process group; returns :func:`topology_info`.

    Runs single-process (a no-op) when no argument is given and neither
    ``RANK`` nor ``WORLD_SIZE`` is set. Otherwise forms the group once:
    ``rank``/``world_size``/``local_rank`` default to torchrun's
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``; the rendezvous is ``store`` (a
    ``torch.distributed.Store``), ``init_method`` (``tcp://host:port`` or
    ``file://path``) or ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).
    ``device`` is the run's device, ``cuda`` unless ``cpu`` is asked for
    (raising without a card, as every entry point does); on the card the
    process binds ``cuda:<local_rank>``. ``backend`` defaults to ``nccl``
    on the card and ``gloo`` on the CPU.

    A rank without a world size raises and names the missing variable (the
    JAX package's rule: a partial pair would fail deep inside the library).
    """
    global _device
    if dist.is_initialized():
        return topology_info()
    if rank is None:
        rank = _env_int("RANK")
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    explicit = init_method is not None or store is not None
    if rank is None and world_size is None and not explicit:
        return topology_info()
    if rank is not None and world_size is None:
        raise ValueError(
            f"distributed init resolved a process rank (rank={rank} via "
            "RANK or the rank argument) but no world size; set WORLD_SIZE "
            "(or pass world_size) so the process group receives the full pair"
        )
    if world_size is not None and rank is None:
        raise ValueError(
            f"distributed init resolved a world size ({world_size}) but no "
            "process rank; set RANK (or pass rank)"
        )
    from erasurehead_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK") or 0
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = dict(backend=backend, world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    if backend == "nccl":
        # binds the communicator to this process's card at init, so the
        # first collective cannot pick another one
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    _device = dev
    return topology_info()


def group_device() -> Optional[torch.device]:
    """The device the process group was formed for, or None without one."""
    return _device if dist.is_initialized() else None


def world_size() -> int:
    """Processes in the group: 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Does this process write the run's files (artifacts, journal rows,
    checkpoints, event logs)? Rank 0 of a group, or a process alone."""
    return not dist.is_initialized() or dist.get_rank() == 0


def agree(value):
    """``value`` as rank 0 of the group has it, on every rank: a host
    decision every rank must take alike, or their collectives deadlock or
    their params part (a tune verdict read from a file another process may
    be writing, a float that steers a controller). One broadcast of a
    picklable object from rank 0; the identity without a group or in a
    world of one. Every rank of the world must call it at the same point."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def topology_info() -> dict:
    """Process and device counts, under the JAX package's keys (the
    reference's size == n_procs sanity check, main.py:55-57). One process
    drives one device, so the global device count is the world size."""
    initialized = dist.is_initialized()
    dev = group_device()
    if dev is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        platform = dev.type
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": world_size(),
        "local_devices": 1,
        "global_devices": world_size(),
        "platform": platform,
    }


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None
    from erasurehead_tpu_torch.parallel import mesh

    mesh._ROW_GROUPS.clear()  # the sub-groups died with their world
