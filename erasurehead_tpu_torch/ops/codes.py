"""Coding-theory core: data-assignment layouts, generator matrices, decode weights.

Host-side numpy, the layouts and host decode of erasurehead_tpu/ops/codes.py
with the same arithmetic and the same random draws, so layouts and decode
weights match the JAX package byte for byte. A *layout* describes which data partitions each logical worker holds
and with which linear-coding coefficient it folds each partition's gradient
into the single message it "sends"; *decode weights* recover (exactly or
approximately) the full-batch gradient from a subset of worker messages.

Reference behavior being matched (file:line in the original ErasureHead
code):
  - cyclic MDS supports (worker w holds partitions w..w+s mod W):
    src/coded.py:33-48, src/util.py:68-73
  - generator matrix B for exact gradient coding: src/util.py:64-83
  - fractional-repetition (FRC) assignment: src/replication.py:46-49,
    src/approximate_coding.py:47-50
  - partial two-slice layouts (unique uncoded partitions + a coded band):
    src/partial_coded.py:20-43,125-126 and src/partial_replication.py:24-50
  - lstsq decode over the completed subset: src/coded.py:147-149
  - the decode table over every straggler pattern: src/util.py:85-134

The on-device decode of the dynamic trainer (parallel/dynamic.py) lives
here too: :func:`mds_decode_weights` (a float32 solve on the run's device)
and :class:`MdsDecodeTable` (every pattern solved once on the host in
float64, looked up on the device by the pattern's combinatorial rank,
:func:`straggler_pattern_index_t`).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CodingLayout:
    """Static description of a coded data assignment.

    Each of the ``n_workers`` logical workers holds ``n_slots`` partition
    slots. Slot ``s`` of worker ``w`` holds global partition
    ``assignment[w, s]`` and contributes ``coeffs[w, s] * grad(partition)`` to
    the worker's transmitted message. Partial ("two-part") schemes mark some
    slots as *separate* (uncoded, always required by the master) via
    ``slot_is_coded[s] == False``.
    """

    name: str
    n_workers: int
    n_partitions: int  # number of distinct global partitions
    assignment: np.ndarray  # [W, S] int32, values in [0, n_partitions)
    coeffs: np.ndarray  # [W, S] float64 linear-coding coefficients
    slot_is_coded: np.ndarray  # [S] bool; False = "separate"/uncoded slot
    n_stragglers: int = 0
    groups: Optional[np.ndarray] = None  # [W] int32 FRC group ids, else None
    B: Optional[np.ndarray] = None  # [W, W] generator matrix (MDS family)

    def __post_init__(self):
        W, S = self.assignment.shape
        if self.n_workers != W:
            raise ValueError(f"assignment has {W} rows for {self.n_workers} workers")
        if self.coeffs.shape != (W, S) or self.slot_is_coded.shape != (S,):
            raise ValueError("coeffs / slot_is_coded do not match assignment")
        if self.assignment.min() < 0 or self.assignment.max() >= self.n_partitions:
            raise ValueError("assignment holds partition ids out of range")

    @property
    def n_slots(self) -> int:
        return self.assignment.shape[1]

    @property
    def n_groups(self) -> int:
        if self.groups is None:
            return self.n_workers
        return int(self.groups.max()) + 1

    @property
    def storage_overhead(self) -> float:
        """Copies of the dataset stored across workers (1.0 = uncoded)."""
        return self.assignment.size / self.n_partitions

    @property
    def uncoded_frac(self) -> float:
        """Partial-scheme timing model: the uncoded ("separate") part is
        sent when its slots are done, i.e. at this fraction of the worker's
        full compute time (parallel/collect.collect_partial)."""
        n_sep = int((~np.asarray(self.slot_is_coded)).sum())
        return n_sep / self.n_slots

    def effective_matrix(self) -> np.ndarray:
        """[W, n_partitions] matrix E with ``message = E @ partition_grads``.

        Row w scatters ``coeffs[w, :]`` into the partition columns this
        worker holds (coded slots only; separate slots form their own
        always-on message in partial schemes).
        """
        E = np.zeros((self.n_workers, self.n_partitions))
        for w in range(self.n_workers):
            for s in range(self.n_slots):
                if self.slot_is_coded[s]:
                    E[w, self.assignment[w, s]] += self.coeffs[w, s]
        return E

    def fold_slot_weights(self, slot_weights: np.ndarray) -> np.ndarray:
        """Fold FINAL per-slot weights [..., W, S] onto per-partition weights.

        ``slot_weights`` must already include the coding coefficients (the
        output of ``parallel.step.expand_slot_weights``). Returns ``p_w``
        [..., n_partitions] such that the decoded gradient equals
        ``sum_p p_w[p] * grad_p``: what makes the deduplicated compute mode
        possible. Host-side float64, arbitrary leading batch dims.
        """
        slot_weights = np.asarray(slot_weights)
        lead = slot_weights.shape[:-2]
        flat = slot_weights.reshape(*lead, -1)  # [..., W*S]
        out = np.zeros((*lead, self.n_partitions))
        np.add.at(
            out.reshape(-1, self.n_partitions),
            (
                np.arange(int(np.prod(lead)) or 1)[:, None],
                self.assignment.reshape(-1)[None, :],
            ),
            flat.reshape(-1, flat.shape[-1]),
        )
        return out


def cyclic_generator_matrix(
    n_workers: int, n_stragglers: int, seed: int = 0
) -> np.ndarray:
    """Random cyclic-support generator matrix B for exact gradient coding.

    Pick H in R^{s x W} whose rows each sum to zero; row i of B is supported
    on {i, ..., i+s mod W} with B[i, i] = 1 and the remaining s entries
    solving H[:, S_i] @ B[i, S_i] = 0. Any W-s rows of B then span the
    all-ones vector, so any W-s messages decode the exact gradient. Rows are
    normalized to unit length.
    """
    if not 0 <= n_stragglers < n_workers:
        raise ValueError("need 0 <= n_stragglers < n_workers")
    if n_stragglers == 0:
        return np.eye(n_workers)
    rng = np.random.default_rng(seed)
    s, W = n_stragglers, n_workers
    H = rng.standard_normal((s, W))
    H[:, -1] = -H[:, :-1].sum(axis=1)  # rows sum to zero => H @ 1 = 0
    B = np.zeros((W, W))
    for i in range(W):
        support = (i + np.arange(s + 1)) % W
        B[i, support[0]] = 1.0
        B[i, support[1:]] = -np.linalg.solve(H[:, support[1:]], H[:, support[0]])
    return B / np.linalg.norm(B, axis=1, keepdims=True)


def uncoded_layout(n_workers: int, n_stragglers: int = 0) -> CodingLayout:
    """One unique partition per worker, coefficient 1 (naive & avoidstragg)."""
    return CodingLayout(
        name="uncoded",
        n_workers=n_workers,
        n_partitions=n_workers,
        assignment=np.arange(n_workers, dtype=np.int32)[:, None],
        coeffs=np.ones((n_workers, 1)),
        slot_is_coded=np.array([True]),
        n_stragglers=n_stragglers,
    )


def cyclic_mds_layout(
    n_workers: int, n_stragglers: int, seed: int = 0
) -> CodingLayout:
    """Cyclic MDS exact gradient coding ("cyccoded"): worker w holds
    partitions w..w+s (mod W), each pre-scaled by B[w, p]."""
    W, s = n_workers, n_stragglers
    B = cyclic_generator_matrix(W, s, seed)
    assignment = (np.arange(W)[:, None] + np.arange(s + 1)[None, :]) % W
    coeffs = np.take_along_axis(B, assignment, axis=1)
    return CodingLayout(
        name="cyclic_mds",
        n_workers=W,
        n_partitions=W,
        assignment=assignment.astype(np.int32),
        coeffs=coeffs,
        slot_is_coded=np.ones(s + 1, dtype=bool),
        n_stragglers=s,
        B=B,
    )


def _frc_groups(n_workers: int, n_stragglers: int) -> np.ndarray:
    if n_workers % (n_stragglers + 1):
        raise ValueError(
            "n_workers must be a multiple of n_stragglers+1 for FRC layouts "
            "(reference guard: src/replication.py:24-26)"
        )
    return (np.arange(n_workers) // (n_stragglers + 1)).astype(np.int32)


def frc_layout(n_workers: int, n_stragglers: int) -> CodingLayout:
    """Fractional repetition code ("repcoded"; also AGC's layout).

    Workers form W/(s+1) groups of s+1; member b of group a holds partitions
    (s+1)a + (b+i) mod (s+1) in slot i. All coefficients are 1."""
    W, s = n_workers, n_stragglers
    groups = _frc_groups(W, s)
    w = np.arange(W)[:, None]
    a, b = w // (s + 1), w % (s + 1)
    i = np.arange(s + 1)[None, :]
    assignment = (s + 1) * a + (b + i) % (s + 1)
    return CodingLayout(
        name="frc",
        n_workers=W,
        n_partitions=W,
        assignment=assignment.astype(np.int32),
        coeffs=np.ones((W, s + 1)),
        slot_is_coded=np.ones(s + 1, dtype=bool),
        n_stragglers=s,
        groups=groups,
    )


def random_regular_layout(
    n_workers: int, n_stragglers: int, seed: int = 0
) -> CodingLayout:
    """Sparse random d-regular bipartite assignment, d = s+1 ("randreg";
    arXiv 1711.06771).

    W partitions; each worker holds d distinct partitions and each partition
    sits on d distinct workers (d superimposed random perfect matchings).
    All coefficients 1; the decode is the least-squares combination of
    whichever messages arrive over the 0/1 incidence matrix B. A matching
    that would hand a worker a duplicate partition is redrawn, up to 200
    times; past that the layout falls back to d shifts of one random
    permutation. The draws are the JAX package's, call for call.
    """
    W, d = n_workers, n_stragglers + 1
    if d > W:
        raise ValueError(f"degree {d} exceeds n_workers {W}")
    rng = np.random.default_rng(seed)
    assignment = np.empty((W, d), dtype=np.int64)

    def _draw() -> bool:
        for k in range(d):
            for _ in range(200):
                perm = rng.permutation(W)
                if k == 0 or not any(
                    perm[w] in assignment[w, :k] for w in range(W)
                ):
                    assignment[:, k] = perm
                    break
            else:
                return False
        return True

    if not _draw():
        sigma = rng.permutation(W)
        for k in range(d):
            assignment[:, k] = (sigma + k) % W
    B = np.zeros((W, W))
    B[np.arange(W)[:, None], assignment] = 1.0
    return CodingLayout(
        name="randreg",
        n_workers=W,
        n_partitions=W,
        assignment=assignment.astype(np.int32),
        coeffs=np.ones((W, d)),
        slot_is_coded=np.ones(d, dtype=bool),
        n_stragglers=n_stragglers,
        B=B,
    )


def sparse_graph_layout(
    n_workers: int, n_stragglers: int, seed: int = 0
) -> CodingLayout:
    """Sparse random bipartite-graph code ("sparsegraph"; arXiv 1711.06771).

    Each of the W partitions lands on exactly d = s+1 workers drawn
    uniformly at random (one ``rng.choice(W, d, replace=False)`` per
    partition), so worker loads come out ragged. The fixed-shape [W, S] slot
    table takes S = the maximum worker degree and pads lighter workers with
    zero-coefficient slots holding partition 0: they add nothing to messages,
    decode folds or the effective matrix, only redundant gradient compute.
    ``w = 1/d`` decodes the exact gradient at full collection; under
    straggling the first-``num_collect`` lstsq rule over the 0/1 incidence
    B degrades gracefully.
    """
    W, d = n_workers, n_stragglers + 1
    if d > W:
        raise ValueError(f"degree {d} exceeds n_workers {W}")
    rng = np.random.default_rng(seed)
    holders = [rng.choice(W, size=d, replace=False) for _ in range(W)]
    per_worker: list[list[int]] = [[] for _ in range(W)]
    for p, ws in enumerate(holders):
        for w in ws:
            per_worker[int(w)].append(p)
    S = max(1, max(len(ps) for ps in per_worker))
    assignment = np.zeros((W, S), dtype=np.int32)
    coeffs = np.zeros((W, S))
    for w, ps in enumerate(per_worker):
        assignment[w, : len(ps)] = ps
        coeffs[w, : len(ps)] = 1.0
    layout = CodingLayout(
        name="sparse_graph",
        n_workers=W,
        n_partitions=W,
        assignment=assignment,
        coeffs=coeffs,
        slot_is_coded=np.ones(S, dtype=bool),
        n_stragglers=n_stragglers,
    )
    # the 0/1 incidence matrix is the effective coding matrix here
    return dataclasses.replace(layout, B=layout.effective_matrix())


def expander_layout(n_workers: int, n_stragglers: int) -> CodingLayout:
    """Deterministic circulant expander-style code ("expander"; arXiv
    1707.03858).

    Worker w holds the d = s+1 partitions ``w + floor(j*W/d) mod W``:
    evenly spread circulant chords, d-regular on both sides, one
    seed-independent layout. Coefficients 1; first-``num_collect`` lstsq
    decoding as for sparsegraph and randreg.
    """
    W, d = n_workers, n_stragglers + 1
    if d > W:
        raise ValueError(f"degree {d} exceeds n_workers {W}")
    offsets = np.array([(j * W) // d for j in range(d)], dtype=np.int64)
    assignment = (np.arange(W)[:, None] + offsets[None, :]) % W
    layout = CodingLayout(
        name="expander",
        n_workers=W,
        n_partitions=W,
        assignment=assignment.astype(np.int32),
        coeffs=np.ones((W, d)),
        slot_is_coded=np.ones(d, dtype=bool),
        n_stragglers=n_stragglers,
    )
    return dataclasses.replace(layout, B=layout.effective_matrix())


def partial_cyclic_layout(
    n_workers: int,
    n_partitions_per_worker: int,
    n_stragglers: int,
    seed: int = 0,
) -> CodingLayout:
    """Partial coded ("partialcyccoded"): unique uncoded slots + cyclic coded band.

    Worker w holds n_sep = p-s-1 unique partitions (global ids n_sep*w + i,
    src/partial_coded.py:33-36) plus s+1 partitions of a shared W-partition
    coded band (global ids n_sep*W + (w + j) mod W, src/partial_coded.py:38-43),
    the coded slots scaled by B[w, (w + j) mod W]. The master requires all
    uncoded parts and decodes the coded band from any W-s coded parts.
    """
    W, p, s = n_workers, n_partitions_per_worker, n_stragglers
    n_sep = p - s - 1
    if n_sep < 1:
        raise ValueError("need n_partitions_per_worker >= n_stragglers + 2")
    B = cyclic_generator_matrix(W, s, seed)
    w = np.arange(W)[:, None]
    sep = n_sep * w + np.arange(n_sep)[None, :]
    band = (w + np.arange(s + 1)[None, :]) % W
    assignment = np.concatenate([sep, n_sep * W + band], axis=1)
    coeffs = np.concatenate(
        [np.ones((W, n_sep)), np.take_along_axis(B, band, axis=1)], axis=1
    )
    return CodingLayout(
        name="partial_cyclic",
        n_workers=W,
        n_partitions=n_sep * W + W,
        assignment=assignment.astype(np.int32),
        coeffs=coeffs,
        slot_is_coded=np.arange(p) >= n_sep,
        n_stragglers=s,
        B=B,
    )


def partial_frc_layout(
    n_workers: int, n_partitions_per_worker: int, n_stragglers: int
) -> CodingLayout:
    """Partial replication ("partialrepcoded"): unique slots + FRC coded band.

    The same unique slice as partial_cyclic; every member of group a holds
    the same s+1 band partitions n_sep*W + a*(s+1) + b, b in 0..s, unscaled
    (src/partial_replication.py:44-50). The master requires all uncoded
    parts plus one coded part per group.
    """
    W, p, s = n_workers, n_partitions_per_worker, n_stragglers
    n_sep = p - s - 1
    if n_sep < 1:
        raise ValueError("need n_partitions_per_worker >= n_stragglers + 2")
    groups = _frc_groups(W, s)
    w = np.arange(W)[:, None]
    sep = n_sep * w + np.arange(n_sep)[None, :]
    band = groups[:, None] * (s + 1) + np.arange(s + 1)[None, :]
    assignment = np.concatenate([sep, n_sep * W + band], axis=1)
    return CodingLayout(
        name="partial_frc",
        n_workers=W,
        n_partitions=n_sep * W + W,
        assignment=assignment.astype(np.int32),
        coeffs=np.ones((W, p)),
        slot_is_coded=np.arange(p) >= n_sep,
        n_stragglers=s,
        groups=groups,
    )


def mds_decode_weights_host(B: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Float64 decode weights for a batch of completion masks.

    For each round's mask, the least-squares solution of
    ``B[live, :].T a = 1`` over the collected workers, zero elsewhere (the
    reference's per-iteration float64 ``np.linalg.lstsq``,
    src/coded.py:147-149). Each distinct mask is solved once.

    Args:
      B: [W, W] generator matrix.
      masks: [rounds, W] boolean completion masks.

    Returns:
      [rounds, W] float64 decode weights, zero outside each mask.
    """
    masks = np.asarray(masks, dtype=bool)
    W = B.shape[0]
    ones = np.ones(W)
    uniq, inverse = np.unique(masks, axis=0, return_inverse=True)
    out = np.zeros(uniq.shape)
    for k in range(uniq.shape[0]):
        live = np.flatnonzero(uniq[k])
        out[k, live] = np.linalg.lstsq(B[live, :].T, ones, rcond=None)[0]
    return out[inverse.reshape(-1)]


def mds_decode_weights(B: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Decode weights ``a`` supported on ``mask`` with ``a @ B ~= 1``, on the
    tensors' device (the JAX package's fixed-shape on-device solve): the
    minimum-norm least-squares solution of ``(mask * B)^T a = 1`` in
    float32 through ``torch.linalg.pinv``, two steps of iterative
    refinement, and a hard zero off the mask. Reliable at small W only: at
    the reference's W = 30 some patterns of the random cyclic code are too
    ill-conditioned for float32 (:class:`MdsDecodeTable` is the remedy). On
    the card the SVD inside ``pinv`` synchronises with the host."""
    Bm = torch.where(mask[:, None], B, torch.zeros_like(B))
    ones = torch.ones(B.shape[0], dtype=B.dtype, device=B.device)
    pinv = torch.linalg.pinv(Bm.T)
    a = pinv @ ones
    for _ in range(2):
        a = a + pinv @ (ones - Bm.T @ a)
    return torch.where(mask, a, torch.zeros_like(a))


def enumerate_decode_table(B: np.ndarray, n_stragglers: int) -> np.ndarray:
    """Float64 decode weights for every C(W, s) straggler pattern, row k for
    the k-th s-subset in ``itertools.combinations`` order (the reference's
    runtime-unused ``getA``, src/util.py:85-103)."""
    W = B.shape[0]
    patterns = list(itertools.combinations(range(W), n_stragglers))
    A = np.zeros((len(patterns), W))
    ones = np.ones(W)
    for k, stragglers in enumerate(patterns):
        live = np.setdiff1d(np.arange(W), stragglers)
        A[k, live] = np.linalg.lstsq(B[live, :].T, ones, rcond=None)[0]
    return A


@dataclasses.dataclass(frozen=True)
class MdsDecodeTable:
    """Float64 decode weights of every straggler pattern of size 0..s,
    solved once on the host, looked up on the device by the completion
    mask: the exact decode at the reference's W = 30, where the float32
    solve fails (:func:`mds_decode_weights`). Patterns of fewer than s
    stragglers are covered for the partial schemes, whose completed set
    can exceed W - s.

    The host arrays are byte-equal to the JAX package's table;
    :meth:`on` moves them to a device once (the table as float32), and
    :meth:`lookup` is a gather there with no host step."""

    table: np.ndarray  # [sum_{r<=s} C(W, r), W] float64 decode weights
    offsets: np.ndarray  # [s+1] int32; the r-straggler block starts at offsets[r]
    comb: np.ndarray  # [W+1, s+1] int32 binomial table for the ranking
    max_stragglers: int
    _device: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def on(self, device) -> tuple:
        """The (table float32, offsets, comb) tensors on ``device``, moved
        there at the first call and kept."""
        # the canonical device ("cuda" -> "cuda:0"), as tensors report it
        device = torch.empty(0, device=device).device
        key = str(device)
        if key not in self._device:
            self._device[key] = (
                torch.from_numpy(self.table.astype(np.float32)).to(device),
                torch.from_numpy(self.offsets.astype(np.int64)).to(device),
                torch.from_numpy(self.comb.astype(np.int64)).to(device),
            )
        return self._device[key]

    def lookup(self, mask: torch.Tensor) -> torch.Tensor:
        """[W] float32 decode weights for a completion mask (True =
        collected), on the mask's device."""
        table, offsets, comb = self.on(mask.device)
        stragglers = ~mask
        rank = straggler_pattern_index_t(stragglers, self.max_stragglers, comb)
        row = offsets.gather(0, stragglers.sum().view(1)) + rank
        return table.index_select(0, row)[0]


def build_decode_table(
    B: np.ndarray,
    max_stragglers: int,
    cap_rows: int = 20_000,
    exact_only: bool = False,
) -> Optional[MdsDecodeTable]:
    """An :class:`MdsDecodeTable`, or None when it would exceed
    ``cap_rows`` rows (randreg at W = 30 collecting 15 needs C(30, 15)).
    ``exact_only`` builds only the exactly-``max_stragglers`` block: the
    first-k rules always complete exactly W - k workers, so the smaller
    blocks would be dead rows counted against the cap."""
    W = B.shape[0]
    counts = [
        0 if (exact_only and r < max_stragglers) else math.comb(W, r)
        for r in range(max_stragglers + 1)
    ]
    if sum(counts) > cap_rows:
        return None
    tables = [
        np.zeros((0, W)) if n == 0 else enumerate_decode_table(B, r)
        for r, n in enumerate(counts)
    ]
    offsets = np.cumsum([0] + [t.shape[0] for t in tables])[:-1]
    comb = np.array(
        [[math.comb(n, r) for r in range(max_stragglers + 1)] for n in range(W + 1)],
        dtype=np.int32,
    )
    return MdsDecodeTable(
        table=np.concatenate(tables, axis=0),
        offsets=offsets.astype(np.int32),
        comb=comb,
        max_stragglers=max_stragglers,
    )


def straggler_pattern_index_t(
    straggler_mask: torch.Tensor, max_stragglers: int, comb_table: torch.Tensor
) -> torch.Tensor:
    """Combinatorial rank of a straggler set among the subsets of its size,
    as a 0-d tensor on the mask's device (the JAX package's
    straggler_pattern_index_jnp): the per-position sum of
    :func:`straggler_pattern_index` telescopes (hockey stick) to
    ``C(W - prev_j - 1, r_j) - C(W - p_j, r_j)`` with ``r_j = count - j``,
    a fixed-shape gather and sum. ``comb_table`` is the [W+1, s+1] int64
    binomial table on that device."""
    W = straggler_mask.shape[0]
    dev = straggler_mask.device
    if max_stragglers == 0:
        return torch.zeros((), dtype=torch.int64, device=dev)
    idx = torch.arange(W, device=dev)
    # ascending straggler positions, padded with the sentinel W (sorts last)
    pos = torch.sort(torch.where(straggler_mask, idx, W)).values[:max_stragglers]
    s_cnt = straggler_mask.sum()
    prev = torch.cat([torch.full((1,), -1, dtype=pos.dtype, device=dev), pos[:-1]])
    j = torch.arange(max_stragglers, device=dev)
    r = torch.clamp(s_cnt - j, 0, max_stragglers)
    hi = comb_table[W - prev - 1, r]
    lo = comb_table[torch.clamp(W - pos, 0, W), r]
    return torch.where(j < s_cnt, hi - lo, torch.zeros_like(hi)).sum()


def straggler_pattern_index(straggler_mask: np.ndarray) -> int:
    """Row of a straggler set in :func:`enumerate_decode_table`: the
    combinatorial rank of its sorted positions in
    ``itertools.combinations(range(W), s)`` order (the reference's lookup
    helpers, src/util.py:105-134)."""
    W = len(straggler_mask)
    positions = np.flatnonzero(straggler_mask)
    index = 0
    prev = -1
    remaining = len(positions)
    for pos in positions:
        for skipped in range(prev + 1, pos):
            index += math.comb(W - skipped - 1, remaining - 1)
        prev = pos
        remaining -= 1
    return index
