"""Plain control plane of the coding schemes a sweep compares.

Worked out again from the configuration alone, in float64 numpy: which
partitions each logical worker holds (with which coefficient), whom the
master hears from each round given the arrival matrix ``t[round, worker]``,
the decode weight of each message, and the simulated clock. The rules are
ErasureHead's (arXiv:1901.09671; file:line in its code):

  naive        wait for all W workers                       src/naive.py:103-110
  cyccoded     first W-s arrivals, lstsq decode over B      src/coded.py:137-149
  repcoded     first arrival of every group                 src/replication.py:143-155
  approx       num_collect arrivals or every group covered  src/approximate_coding.py:144-158
  avoidstragg  first W-s, rescaled by W/(W-s)               src/avoidstragg.py:106-116

and three beyond it: randreg (a random d-regular code, the first
num_collect arrivals, lstsq decode; arXiv:1711.06771 + 2006.09638) and
deadline (whatever arrived by the cutoff, rescaled by W/collected).

Arrivals are processed in ascending (time, worker) order, one worker at a
time, as the reference's ``Waitany`` loop takes them. The layouts that are
drawn from a seed (cyclic MDS's generator matrix, randreg's matchings) make
the draws of ``erasurehead_tpu_torch/ops/codes.py`` call for call, since
the seed names the code.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Layout:
    assignment: np.ndarray  # [W, S] partition of each worker slot
    coeffs: np.ndarray  # [W, S] coding coefficient of each slot
    groups: np.ndarray | None = None  # [W] repetition group, FRC layouts
    B: np.ndarray | None = None  # [W, P] code matrix of lstsq decodes


def _cyclic_generator(W: int, s: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((s, W))
    H[:, -1] = -H[:, :-1].sum(axis=1)
    B = np.zeros((W, W))
    for i in range(W):
        sup = (i + np.arange(s + 1)) % W
        B[i, sup[0]] = 1.0
        B[i, sup[1:]] = -np.linalg.solve(H[:, sup[1:]], H[:, sup[0]])
    return B / np.linalg.norm(B, axis=1, keepdims=True)


def _random_regular(W: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = np.empty((W, d), dtype=np.int64)
    for k in range(d):
        for _ in range(200):
            perm = rng.permutation(W)
            if k == 0 or not any(perm[w] in a[w, :k] for w in range(W)):
                a[:, k] = perm
                break
        else:
            sigma = rng.permutation(W)
            return (sigma[:, None] + np.arange(d)[None, :]) % W
    return a


def layout(scheme: str, W: int, s: int, seed: int) -> Layout:
    if scheme in ("naive", "avoidstragg", "deadline"):
        return Layout(np.arange(W)[:, None], np.ones((W, 1)))
    if scheme in ("repcoded", "approx"):
        if W % (s + 1):
            raise ValueError(f"{scheme} needs (s+1) | W, got W={W}, s={s}")
        w = np.arange(W)[:, None]
        grp, member = w // (s + 1), w % (s + 1)
        assignment = (s + 1) * grp + (member + np.arange(s + 1)[None, :]) % (s + 1)
        return Layout(assignment, np.ones((W, s + 1)), groups=grp[:, 0])
    if scheme == "cyccoded":
        B = _cyclic_generator(W, s, seed)
        assignment = (np.arange(W)[:, None] + np.arange(s + 1)[None, :]) % W
        return Layout(assignment, np.take_along_axis(B, assignment, axis=1), B=B)
    if scheme == "randreg":
        assignment = _random_regular(W, s + 1, seed)
        B = np.zeros((W, W))
        B[np.arange(W)[:, None], assignment] = 1.0
        return Layout(assignment, np.ones((W, s + 1)), B=B)
    raise ValueError(f"no plain control plane for scheme {scheme!r}")


def _lstsq(B: np.ndarray, live: np.ndarray) -> np.ndarray:
    out = np.zeros(B.shape[0])
    out[live] = np.linalg.lstsq(B[live].T, np.ones(B.shape[1]), rcond=None)[0]
    return out


def schedule(scheme: str, t: np.ndarray, lay: Layout, *, n_stragglers: int,
             num_collect: int | None = None, deadline: float | None = None):
    """(message weights [R, W], simulated seconds a round [R])."""
    R, W = t.shape
    weights = np.zeros((R, W))
    clock = np.zeros(R)
    solved: dict = {}
    for r in range(R):
        order = np.argsort(t[r], kind="stable")
        if scheme == "naive":
            weights[r] = 1.0
            clock[r] = t[r].max()
        elif scheme == "deadline":
            got = t[r] <= deadline
            weights[r] = got * (W / max(int(got.sum()), 1))
            clock[r] = t[r].max() if got.all() else deadline
        elif scheme in ("avoidstragg", "cyccoded", "randreg"):
            k = W - n_stragglers if scheme != "randreg" else num_collect
            live = np.sort(order[:k])
            if scheme == "avoidstragg":
                weights[r, live] = W / k
            else:
                key = live.tobytes()
                if key not in solved:
                    solved[key] = _lstsq(lay.B, live)
                weights[r] = solved[key]
            clock[r] = t[r, order[k - 1]]
        elif scheme in ("approx", "repcoded"):
            quota = num_collect if scheme == "approx" else W + 1
            n_groups = int(lay.groups.max()) + 1
            covered = set()
            for j, w in enumerate(order):
                g = int(lay.groups[w])
                if g not in covered:
                    covered.add(g)
                    weights[r, w] = 1.0
                if j + 1 >= quota or len(covered) == n_groups:
                    clock[r] = t[r, w]
                    break
        else:
            raise ValueError(f"no plain collection rule for scheme {scheme!r}")
    return weights, clock


def partition_weights(lay: Layout, weights: np.ndarray, n_partitions: int) -> np.ndarray:
    """[R, P]: the weight of each partition's gradient in the decoded one,
    sum over the slots holding it of message weight x coefficient."""
    R, W = weights.shape
    out = np.zeros((R, n_partitions))
    slot = weights[:, :, None] * lay.coeffs[None]  # [R, W, S]
    for w in range(W):
        for s in range(lay.assignment.shape[1]):
            out[:, lay.assignment[w, s]] += slot[:, w, s]
    return out
