"""Coding-theory core: data-assignment layouts, generator matrices, decode weights.

Host-side numpy, the main-path subset of erasurehead_tpu/ops/codes.py with the
same arithmetic, so layouts and decode weights match the JAX package byte for
byte. A *layout* describes which data partitions each logical worker holds
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
  - lstsq decode over the completed subset: src/coded.py:147-149
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CodingLayout:
    """Static description of a coded data assignment.

    Each of the ``n_workers`` logical workers holds ``n_slots`` partition
    slots. Slot ``s`` of worker ``w`` holds global partition
    ``assignment[w, s]`` and contributes ``coeffs[w, s] * grad(partition)`` to
    the worker's transmitted message. ``slot_is_coded[s] == False`` marks a
    separate (uncoded, always required) slot of the partial schemes, which
    this port does not run yet; every ported layout has only coded slots.
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

    def effective_matrix(self) -> np.ndarray:
        """[W, n_partitions] matrix E with ``message = E @ partition_grads``."""
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
