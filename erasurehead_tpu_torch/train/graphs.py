"""The round loop as CUDA graphs: the port's compiled scan.

The JAX trainers run each chunk of rounds as one jitted ``lax.scan``,
compiled once per chunk length and reused across a sweep's runs
(erasurehead_tpu/train/trainer.py, train/cache.py). On an NVIDIA card the
counterpart of a compiled executable is a CUDA graph: a :class:`Program`
captures the round once and replays it, so a round costs one graph launch
on the host instead of the hundred-odd kernel launches of the eager loop.

A program is built for one chunk length ``n`` and holds:

  - **static buffers**: the carry (params, optimizer momentum, a pipelined
    run's stale params slot), the per-round tables (decode weights, the
    optimizer's round scalars, the round keys of the on-device control
    plane) as ``[n, ...]`` tensors, the run's constants (a cohort's alphas),
    the per-round outputs (the iterate history, the on-device clocks) and a
    device round counter. A graph bakes in the address of every tensor it
    reads, so a run copies its starting carry, tables and constants in
    (:meth:`Program.run`), replays, and copies its history and final carry
    out; the values it varies never live in the graph;
  - **a graph of u = min(scan_unroll, n) rounds**, each round reading its
    row of every table at the counter and advancing it, and a tail graph of
    ``n mod u`` rounds: a chunk is ``ceil(n / u)`` replays (the JAX
    package's unroll factor, read as rounds per replay).

Capture first runs one round on a side stream (the warm-up CUDA graphs need
for lazy initialisation: cuBLAS handles, the kernel library, the sparse
stacks' index plans), on the program's own copies of the run's carry and
tables, then captures under ``capture_error_mode="thread_local"`` and under
one process lock, so the serve daemon's dispatch threads keep running their
own work. A round that cannot be captured (one that reads the device from
the host) raises: nothing falls back to the eager loop. Which paths stay
eager is decided by name before any capture (train/trainer._loop_mode).

Every program captures into one memory pool per device (:func:`_shared_pool`):
its intermediates are dead once a replay ends, so the pool holds the
largest round's. The pool's bytes are a device-level figure
(:func:`pool_bytes`), counted once beside the programs' static buffers by
the executable cache's byte bound (cache.EXEC_CACHE_BYTES) and by the serve
daemon's admission.

Kernel launches: the wrappers in ops/kernels.py count a launch where they
launch. Under capture the launches go to the graph's tally
(kernels.recording) and each replay adds the tally to ``kernels.LAUNCHES``,
so a run counts what the eager loop counts; the warm-up is not counted.

:func:`disabled` is the counterpart of ``jax.disable_jit``: the trainers run
their round function uncaptured on the card inside it (the check that a
graph run is bitwise its eager run). The uncaptured executor,
:func:`run_eager`, is the same round function the program captures, run
once a round with its row read by host index: the CPU's loop, and the loop
of every path that stays eager.

Device-wide synchronisation is illegal while another thread captures, so
the trainers synchronise through :func:`sync`, which waits for any capture
in progress.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.ops import kernels

_local = threading.local()

#: serialises captures, and keeps device-wide synchronisation out of them
_capture_cond = threading.Condition()
_capturing = False
_syncing = 0


@contextlib.contextmanager
def disabled():
    """Run the trainers' round loops uncaptured in this thread
    (:func:`run_eager`), on the card too (``jax.disable_jit``'s
    counterpart): no program is built or replayed, and the runs' ``compile``
    records say so."""
    depth = getattr(_local, "disabled", 0)
    _local.disabled = depth + 1
    try:
        yield
    finally:
        _local.disabled = depth


def is_disabled() -> bool:
    return getattr(_local, "disabled", 0) > 0


def sync(device) -> None:
    """``torch.cuda.synchronize(device)``, outside any capture: a
    device-wide synchronisation while another thread captures would
    invalidate its graph."""
    global _syncing
    if device.type != "cuda":
        return
    with _capture_cond:
        while _capturing:
            _capture_cond.wait()
        _syncing += 1
    try:
        torch.cuda.synchronize(device)
    finally:
        with _capture_cond:
            _syncing -= 1
            _capture_cond.notify_all()


@contextlib.contextmanager
def _capture_guard():
    global _capturing
    with _capture_cond:
        while _capturing or _syncing:
            _capture_cond.wait()
        _capturing = True
    try:
        yield
    finally:
        with _capture_cond:
            _capturing = False
            _capture_cond.notify_all()


# ---------------------------------------------------------------------------
# donation


class Donated(torch.Tensor):
    """A tensor whose storage a donating run released: every operation on
    it raises (the JAX package's read of a donated buffer fails on a TPU,
    and passes silently on its CPU backend)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        raise RuntimeError(
            f"{name}: this tensor was donated to a training run (RunConfig.donate) "
            "and its storage released; read the run's result instead"
        )


def donates(*positions, names=()):
    """Mark a function as donating its arguments at ``positions`` and its
    keyword arguments ``names``: the counterpart of ``jax.jit(...,
    donate_argnums=...)``. The mark is read from the source by the
    ``donation-safety`` lint (analysis/donation.py), which flags a plain
    name read after it was passed there; at run time it changes nothing."""
    return lambda fn: fn


@donates(0)
def release(tensors) -> None:
    """Donate ``tensors``: free their storage now and make any later read
    raise (:class:`Donated`). Each tensor is released once."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and type(t) is not Donated:
            t.set_()
            t.__class__ = Donated


# ---------------------------------------------------------------------------
# the program


class _Pool:
    """A device's one graph memory pool: its handle, the programs holding
    it, and its reserved bytes (the growth of the allocator's reserved
    bytes across every capture into it: a device-level figure, not any one
    program's)."""

    __slots__ = ("handle", "holders", "reserved")

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.holders = weakref.WeakSet()
        self.reserved = 0


#: device index -> the _Pool every program's graphs capture into
_pools: dict = {}


def _shared_pool(device, program) -> _Pool:
    """The device's one graph memory pool, for ``program``'s capture (under
    the capture guard). A replay leaves nothing live in the pool (the carry,
    the tables and the outputs are static buffers outside it) and replays
    run one after another on the stream, so every program's intermediates
    share its memory: the pool grows to the largest round's, not to the sum
    over the cache. Once no program holds the pool the allocator frees it,
    and the next capture takes a new one."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    pool = _pools.get(index)
    if pool is None or not pool.holders:
        pool = _pools[index] = _Pool()
    pool.holders.add(program)
    return pool


def pool_bytes() -> int:
    """Device bytes the shared graph pools hold, each counted once: the
    pools some program still holds (the executable cache's byte bound and
    the serve daemon's admission charge them)."""
    return sum(p.reserved for p in _pools.values() if p.holders)


def _rows(leaves, ctr):
    """Each table's row at the device counter (a gather, no host read)."""
    return [t.index_select(0, ctr)[0] for t in leaves]


class Program:
    """One chunk length's captured round loop (one executable-cache entry).

    ``round_fn(carry, row, consts) -> (new_carry, outs)`` is one round:
    ``carry`` and ``new_carry`` trees of the same structure, ``row`` the
    round's row of every table, ``outs`` the tree of per-round outputs
    recorded at the round's index. ``carry``, ``tables`` (leaves
    ``[n, ...]``) and ``consts`` are the first run's values: the program
    takes copies as its static buffers and warms up on them. ``holds`` names
    the data stacks the round reads (cache.stack_token), so dropping a stack
    drops the programs that read it."""

    def __init__(self, round_fn, carry, tables, consts, *, n: int, unroll: int,
                 holds=(), sync_debug: str | None = None):
        if n < 1:
            raise ValueError(f"a program covers at least one round, got n={n}")
        leaves, self._carry_spec = pytree.tree_flatten(carry)
        self.device = leaves[0].device
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {self.device}")
        self.n = int(n)
        self.unroll = min(int(unroll), self.n)
        self.tail = self.n % self.unroll
        self.holds = tuple(holds)
        self.round_fn = round_fn
        self.lock = threading.Lock()
        self._carry = [t.clone() for t in leaves]
        leaves, self._table_spec = pytree.tree_flatten(tables)
        self._tables = [t.clone() for t in leaves]
        if any(t.shape[0] != self.n for t in self._tables):
            raise ValueError(f"every table must have {self.n} rows")
        leaves, self._const_spec = pytree.tree_flatten(consts)
        self._consts = [t.clone() for t in leaves]
        self._ctr = torch.zeros(1, dtype=torch.long, device=self.device)
        self._outs = None
        self.tally: dict = {}
        self.tail_tally: dict = {}
        self._graph = self._tail_graph = None
        self.pool_growth = self.pool_reserved = 0
        self._capture(sync_debug)

    # -- one round over the static buffers ----------------------------------

    def _round(self) -> None:
        carry = pytree.tree_unflatten(self._carry, self._carry_spec)
        row = pytree.tree_unflatten(_rows(self._tables, self._ctr), self._table_spec)
        consts = pytree.tree_unflatten(self._consts, self._const_spec)
        new, outs = self.round_fn(carry, row, consts)
        new_leaves, spec = pytree.tree_flatten(new)
        if spec != self._carry_spec:
            raise ValueError(f"round_fn changed the carry's structure: {spec}")
        # a new leaf that is another slot's static buffer (a pipelined run's
        # stale slot takes the entering params) is copied before any write
        ids = {id(t): k for k, t in enumerate(self._carry)}
        new_leaves = [v.clone() if ids.get(id(v), k) != k else v
                      for k, v in enumerate(new_leaves)]
        for s, v in zip(self._carry, new_leaves):
            s.copy_(v)
        out_leaves = pytree.tree_leaves(outs)
        if self._outs is None:  # the warm-up sizes the output buffers
            self._outs = [torch.zeros((self.n,) + tuple(v.shape), dtype=v.dtype,
                                      device=v.device) for v in out_leaves]
        for o, v in zip(self._outs, out_leaves):
            o.index_copy_(0, self._ctr, v.unsqueeze(0))
        self._ctr.add_(1)

    def _capture(self, sync_debug: str | None = None) -> None:
        """Warm up one round on a side stream, then capture the u-round
        graph and the tail graph into the shared memory pool, recording the
        bytes the pool grew by (added to the pool's reserved bytes).
        ``sync_debug`` ("warn" or "error") runs the warm-up under
        ``torch.cuda.set_sync_debug_mode``: the round's operations that
        would wait for the device, named before the capture refuses them."""
        with _capture_guard():
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side), kernels.recording({}):
                if sync_debug:
                    torch.cuda.set_sync_debug_mode(sync_debug)
                try:
                    self._round()
                finally:
                    if sync_debug:
                        torch.cuda.set_sync_debug_mode("default")
            cur.wait_stream(side)
            torch.cuda.synchronize(self.device)
            # torch.cuda.graph empties the allocator's cache on entry: empty
            # it first, so the reserved bytes that grow across the capture
            # are the private pool's
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            shared = _shared_pool(self.device, self)
            pool = shared.handle
            self._graph = torch.cuda.CUDAGraph()
            with kernels.recording(self.tally), torch.cuda.graph(
                    self._graph, pool=pool, capture_error_mode="thread_local"):
                for _ in range(self.unroll):
                    self._round()
            if self.tail:
                self._tail_graph = torch.cuda.CUDAGraph()
                with kernels.recording(self.tail_tally), torch.cuda.graph(
                        self._tail_graph, pool=pool, capture_error_mode="thread_local"):
                    for _ in range(self.tail):
                        self._round()
            torch.cuda.synchronize(self.device)
            self.pool_growth = max(torch.cuda.memory_reserved(self.device) - before, 0)
            shared.reserved += self.pool_growth
            self.pool_reserved = shared.reserved

    # -- a run ----------------------------------------------------------------

    @property
    def replays(self) -> int:
        """Graph launches a run of this program makes: ceil(n / u)."""
        return self.n // self.unroll + (1 if self.tail else 0)

    @property
    def nbytes(self) -> int:
        """Device bytes the program alone pins: its static buffers (the
        executable cache's byte bound counts them, and the shared pool once,
        :func:`pool_bytes`)."""
        bufs = self._carry + self._tables + self._consts + (self._outs or [])
        return sum(t.numel() * t.element_size() for t in bufs)

    def memory_analysis(self) -> dict:
        """The ``compile`` record's memory fields: the shared graph pool's
        reserved bytes once this program was captured, the bytes it grew by
        at this capture (the round's intermediates beyond what earlier
        programs left it) and the static buffers' bytes."""
        return {"graph_pool_bytes": int(self.pool_reserved),
                "pool_growth_bytes": int(self.pool_growth),
                "static_bytes": int(self.nbytes), "replays": self.replays,
                "unroll": self.unroll}

    @donates(names=("donate",))
    def run(self, carry, tables, consts, out, donate=()):
        """One run: copy ``carry``, ``tables`` and ``consts`` into the
        static buffers, release ``donate`` (:func:`release`), replay, copy
        the per-round outputs into ``out`` (a tree like the outputs, leaves
        ``[n, ...]``) and return the final carry as new tensors. Holds the
        program's lock throughout: two threads never interleave on one
        program's buffers."""
        with self.lock:
            for dst, src in ((self._carry, carry), (self._tables, tables),
                             (self._consts, consts)):
                for s, v in zip(dst, pytree.tree_leaves(src)):
                    s.copy_(v)
            self._ctr.zero_()
            release(donate)
            for _ in range(self.n // self.unroll):
                self._graph.replay()
                kernels.add_launches(self.tally)
            if self._tail_graph is not None:
                self._tail_graph.replay()
                kernels.add_launches(self.tail_tally)
            final = pytree.tree_unflatten([s.clone() for s in self._carry], self._carry_spec)
            for dst, o in zip(pytree.tree_leaves(out), self._outs):
                dst.copy_(o)
            sync(self.device)
        return final


def run_eager(round_fn, carry, tables: dict, consts, out):
    """The round loop uncaptured: the same ``round_fn`` a :class:`Program`
    captures, called once a round with row ``i`` of every table (a dict of
    ``[n, ...]`` tensors) read by host index (a view: no gather, no
    counter), its outputs written into row ``i`` of ``out`` and its new
    carry rebound, the per-round work of an eager loop. Returns the final
    carry. The CPU's loop, and that of every path that stays eager on the
    card."""
    n = next(iter(tables.values())).shape[0]
    out_leaves = pytree.tree_leaves(out)
    for i in range(n):
        carry, outs = round_fn(carry, {k: t[i] for k, t in tables.items()}, consts)
        for dst, v in zip(out_leaves, pytree.tree_leaves(outs)):
            dst[i].copy_(v)
    return carry


#: the executable-cache entry of a loop that runs eagerly (the CPU's, where
#: nothing is captured): it counts as the JAX package's CPU executable does
EAGER = type("EagerLoop", (), {"holds": (), "__repr__": lambda self: "EAGER"})()
