"""The row schedule of kernel B1 (``csrc/glm_grad_plan.h``), on the CPU.

The header is plain C++ (its CUDA qualifiers sit behind ``__CUDACC__``), so a
small harness built here with g++ runs the same functions the kernel runs on
the card: the persistent grid, each CTA's contiguous range of flat rows, its
slot segments, its stages' byte spans (bulk copy and ragged head and tail),
the reduction groups, and the column tiles a cluster of CTAs splits wider
rows into. Every check below is computed independently in
Python, over shapes that include fewer flat rows than CTAs, R = 1, widths
whose rows are not 16-byte multiples, bases that are not 16-byte aligned
and stacks past 2^31 bytes. Skips only where g++ is missing.
"""

import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from erasurehead_tpu_torch.ops import kernels as t_kernels

CSRC = Path(t_kernels.__file__).resolve().parent.parent / "csrc"

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include "glm_grad_plan.h"

// stdin: "rows n_rows R row_bytes base max_ctas stage_rows Fp", or
// "tiles F max_cols base row_bytes es g", or "bytes start end"
int rows() {
  long long n_rows, R, row_bytes, max_ctas, k, Fp;
  unsigned long long base;
  if (std::scanf("%lld %lld %lld %llu %lld %lld %lld", &n_rows, &R, &row_bytes, &base,
                 &max_ctas, &k, &Fp) != 7)
    return 2;
  const long long G = eh_plan_grid(n_rows, max_ctas);
  std::printf("plan %lld %d %d\n", G, eh_plan_group_size((int)G, Fp),
              eh_plan_groups((int)G, Fp));
  for (long long c = 0; c < G; ++c) {
    const long long b = eh_plan_row_begin(n_rows, G, c);
    const long long e = eh_plan_row_begin(n_rows, G, c + 1);
    const long long n_st = eh_plan_stages(b, e, k);
    std::printf("cta %lld %lld %lld %lld\n", c, b, e, n_st);
    for (long long g = b; g < e;) {
      const EhSegment s = eh_plan_segment(g, e, R);
      std::printf("seg %lld %lld %lld %lld\n", c, s.slot, s.begin, s.end);
      g = s.end;
    }
    for (long long j = 0; j < n_st; ++j) {
      const long long g0 = b + j * k;
      const long long g1 = g0 + k < e ? g0 + k : e;
      const EhSpan p = eh_plan_span(base, g0, g1, row_bytes);
      std::printf("st %lld %lld %llu %llu %llu %llu %llu %llu %llu %llu\n", g0, g1, p.start,
                  p.lo, p.end, p.head_bytes, p.bulk_src, p.bulk_bytes, p.tail_src,
                  p.tail_bytes);
    }
  }
  return 0;
}

// a row's column tiles, and the byte span of each tile of row g
int tiles() {
  long long F, max_cols, row_bytes, es, g;
  unsigned long long base;
  if (std::scanf("%lld %lld %llu %lld %lld %lld", &F, &max_cols, &base, &row_bytes, &es, &g) != 6)
    return 2;
  const int n = eh_plan_tiles(F, max_cols);
  std::printf("tiles %d\n", n);
  for (int k = 0; k < n; ++k) {
    const long long c0 = eh_plan_tile_begin(F, n, k), c1 = eh_plan_tile_begin(F, n, k + 1);
    const unsigned long long a = base + g * row_bytes + c0 * es;
    const EhSpan p = eh_plan_bytes(a, a + (c1 - c0) * es);
    std::printf("tile %lld %lld %llu %llu %llu %llu %llu %llu %llu %llu\n", c0, c1, p.start,
                p.lo, p.end, p.head_bytes, p.bulk_src, p.bulk_bytes, p.tail_src, p.tail_bytes);
  }
  return 0;
}

int main() {
  char mode[16];
  if (std::scanf("%15s", mode) != 1) return 2;
  return std::strcmp(mode, "rows") == 0 ? rows() : tiles();
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the plan harness cannot be built")
    d = tmp_path_factory.mktemp("glm_plan")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-I", str(CSRC), "-o",
                    str(exe), str(src)], check=True, capture_output=True, text=True)
    return exe


def _plan(exe, n_rows, R, row_bytes, base, max_ctas, k, Fp):
    out = subprocess.run([str(exe)],
                         input=f"rows {n_rows} {R} {row_bytes} {base} {max_ctas} {k} {Fp}",
                         capture_output=True, text=True, check=True).stdout
    plan, ctas, segs, stages = None, [], [], []
    for line in out.splitlines():
        tag, *vals = line.split()
        vals = [int(v) for v in vals]
        if tag == "plan":
            plan = vals
        elif tag == "cta":
            ctas.append(vals)
        elif tag == "seg":
            segs.append(vals)
        else:
            stages.append(vals)
    return plan, ctas, segs, stages


# (M, R, F, element bytes, base offset in bytes, CTAs the card holds, rows
# per stage): the kernel's row path holds 264 CTAs (two an SM) with 64 float32
# or 128 bfloat16 rows of 128 columns a stage; its column path 132 CTAs of
# one to eight rows a stage
CASES = [
    (1, 3, 128, 4, 0, 264, 64),  # fewer flat rows than CTAs
    (2, 1, 7, 4, 0, 264, 256),  # R = 1, F = 7: 28-byte rows
    (2, 1, 7, 2, 0, 264, 256),
    (300, 1, 64, 4, 0, 264, 128),  # R = 1: every row its own slot
    (90, 4400, 128, 4, 0, 264, 64),  # the main path
    (90, 4400, 128, 2, 0, 264, 128),
    (7, 1000, 96, 4, 0, 264, 85),  # ranges across slot boundaries
    (3, 5, 17, 4, 5 * 17 * 4, 264, 256),  # X[1:] of an F = 17 stack: base % 16 == 4
    (4, 33, 17, 2, 33 * 17 * 2, 264, 256),  # bfloat16: base % 16 == 2
    (2, 40, 15509, 4, 0, 132, 1),  # the covtype width
    (6, 2200, 15509, 4, 0, 132, 1),
    (6, 2200, 15509, 2, 0, 132, 2),
    (30, 4400, 2048, 4, 0, 264, 4),
    (3, 7, 16384, 4, 7 * 16384 * 4, 132, 1),  # the widest rows
    (9, 4_000_000, 17, 4, 12, 132, 65_536),  # 2.45 GB of odd rows: offsets past 2^31
    (64, 100_000, 128, 4, 0, 132, 8_192),  # 3.3 GB
    (1, 40_000_000, 1, 2, 6, 131, 100_003),  # 80 MB of 2-byte rows, a prime grid
]


def _random_cases(n=24, seed=20):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        M, R = int(rng.integers(1, 40)), int(rng.integers(1, 3000))
        F, es = int(rng.integers(1, 3000)), int(rng.choice([2, 4]))
        base = int(rng.integers(0, 1 << 40)) * es
        out.append((M, R, F, es, base, int(rng.choice([1, 7, 132, 264])),
                    int(rng.integers(1, 300))))
    return out


def _check_span(span, start, end):
    """A byte span's head, bulk copy and tail (eh_plan_bytes): a bulk copy's
    source, size and shared-memory offset are 16-byte aligned."""
    s0, lo, e0, head, bulk_src, bulk, tail_src, tail = span
    assert (s0, e0) == (start, end) and lo == start & ~15
    assert head + bulk + tail == end - start
    assert 0 <= head < 16 and 0 <= tail < 16
    assert bulk_src == start + head and tail_src == bulk_src + bulk
    if bulk:
        assert bulk_src % 16 == 0 and bulk % 16 == 0 and (bulk_src - lo) in (0, 16)
    else:
        assert tail == 0 and head == end - start


@pytest.mark.parametrize("case", CASES + _random_cases(), ids=str)
def test_plan_covers_every_row_once_in_contiguous_ranges(harness, case):
    M, R, F, es, offset, max_ctas, k = case
    base = (0x7F3A_0000_0000 if offset < (1 << 32) else 0) + offset
    n_rows, row_bytes, Fp = M * R, F * es, -(-F // 4) * 4
    (G, gs, ng), ctas, segs, stages = _plan(harness, n_rows, R, row_bytes, base, max_ctas, k, Fp)

    # the grid: every CTA the card holds, never more than the rows
    assert G == min(max_ctas, n_rows) >= 1 and len(ctas) == G
    # contiguous ranges in CTA order, as even as they go
    begins = np.array([c[1] for c in ctas], dtype=np.int64)
    ends = np.array([c[2] for c in ctas], dtype=np.int64)
    assert begins[0] == 0 and ends[-1] == n_rows
    assert (begins[1:] == ends[:-1]).all()
    sizes = ends - begins
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    assert sizes.sum() == n_rows  # with contiguity: every row exactly once

    # slot segments: each CTA's range split at slot boundaries, slot g // R
    by_cta = {}
    for c, slot, b, e in segs:
        by_cta.setdefault(c, []).append((slot, b, e))
    for c, b, e, _ in ctas:
        walk = by_cta[c]
        assert walk[0][1] == b and walk[-1][2] == e
        for (slot, sb, se), nxt in zip(walk, walk[1:] + [None]):
            assert sb < se and slot == sb // R == (se - 1) // R
            assert se == e or se % R == 0
            if nxt is not None:
                assert nxt[1] == se and nxt[0] == slot + 1

    # stages: each CTA's rows k at a time, and their byte spans
    assert len(stages) == sum(c[3] for c in ctas) == sum(-(-int(s) // k) for s in sizes)
    covered = 0
    for g0, g1, *span in stages:
        assert 0 < g1 - g0 <= k
        _check_span(span, base + g0 * row_bytes, base + g1 * row_bytes)
        assert span[2] - span[1] <= k * row_bytes + 15  # the stage's bytes from lo
        covered += g1 - g0
    assert covered == n_rows

    # reduction groups: one where the partials are small, else ~sqrt(G)
    assert gs * ng >= G > (ng - 1) * gs
    if G * Fp <= 1 << 16:
        assert (gs, ng) == (G, 1)
    else:
        assert gs == math.isqrt(G - 1) + 1 if G > 1 else gs == 1


# (F, element bytes, base offset in bytes, row g): rows a cluster of CTAs
# splits by columns, from two tiles to eight, and past eight (the kernel
# re-reads those rows instead; the plan still tiles them)
TILE_CASES = [
    (16385, 4, 0, 0), (20000, 4, 0, 5), (20001, 4, 3 * 7 * 20001 * 4, 2),
    (20001, 2, 4 * 33 * 20001 * 2, 31), (32768, 4, 0, 1), (32769, 2, 6, 7),
    (70000, 2, 0, 17), (131071, 4, 12, 3), (131072, 4, 7 * 131072 * 4, 6),
    (131073, 4, 4, 1), (1_000_003, 2, 2, 40_000),
]


def _tiles(exe, F, base, es, g, max_cols=16384):
    out = subprocess.run([str(exe)], input=f"tiles {F} {max_cols} {base} {F * es} {es} {g}",
                         capture_output=True, text=True, check=True).stdout.splitlines()
    n = int(out[0].split()[1])
    return n, [[int(v) for v in line.split()[1:]] for line in out[1:]]


def _random_tile_cases(n=12, seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        es = int(rng.choice([2, 4]))
        out.append((int(rng.integers(16385, 140_000)), es, int(rng.integers(0, 1 << 30)) * es,
                    int(rng.integers(0, 5000))))
    return out


@pytest.mark.parametrize("case", TILE_CASES + _random_tile_cases(), ids=str)
def test_tiles_cover_every_column_once(harness, case):
    F, es, offset, g = case
    base = 0x7F3A_0000_0000 + offset
    n, tiles = _tiles(harness, F, base, es, g)
    assert n == -(-F // 16384) == len(tiles)
    bounds = [(c0, c1) for c0, c1, *_ in tiles]
    # contiguous, in order, from column 0 to F: every column exactly once
    assert bounds[0][0] == 0 and bounds[-1][1] == F
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    widths = [c1 - c0 for c0, c1 in bounds]
    # no tile empty or wider than a CTA holds; all but the last one width,
    # a multiple of 4, so every tile keeps its row's 16-byte alignment
    assert min(widths) >= 1 and max(widths) <= 16384
    assert len(set(widths[:-1])) <= 1 and all(c0 % 4 == 0 for c0, _ in bounds)
    for c0, c1, *span in tiles:
        start = base + g * F * es + c0 * es
        _check_span(span, start, start + (c1 - c0) * es)
