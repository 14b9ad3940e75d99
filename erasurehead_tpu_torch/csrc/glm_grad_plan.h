// Row schedule of kernel B1 (fused_glm_grad.cu), in plain C++.
//
// The kernel runs a persistent grid: CTA c owns one contiguous range of the
// flat rows g = m * R + r of the [M, R, F] stack, so its share of X is one
// contiguous byte span whatever F is. It walks that range a stage of k rows
// at a time, copying each stage's bytes into shared memory with one bulk
// (TMA) copy of the 16-byte-aligned interior and direct loads of the ragged
// head and tail. A range may cross slot boundaries: the rows of one slot m
// form a segment, and the CTA weights each segment's rows by w[m]. The
// per-CTA partial gradients are summed in a fixed order: the last CTA of
// each group of consecutive CTAs to finish sums its group, and (with more
// than one group) the last group to finish sums the group sums. Rows wider
// than a CTA's registers hold are split by columns over the CTAs of a
// cluster, which then takes the place of a CTA here: it owns a range of
// rows and writes one partial.
//
// Everything here is arithmetic on integers, shared by the host (grid and
// scratch sizes), the device (each CTA's walk) and a CPU test that
// compiles this header with g++ (tests/test_torch_glm_plan.py). Offsets are
// 64-bit: a stack may pass 2^31 bytes.

#pragma once

#ifdef __CUDACC__
#define EH_PLAN_FN __host__ __device__ __forceinline__
#else
#define EH_PLAN_FN inline
#endif

// CTAs for n_rows rows when max_ctas can be resident: never more CTAs than
// rows, so every CTA owns at least one row.
EH_PLAN_FN long long eh_plan_grid(long long n_rows, long long max_ctas) {
  const long long g = n_rows < max_ctas ? n_rows : max_ctas;
  return g < 1 ? 1 : g;
}

// First flat row of CTA c (c = n_ctas gives n_rows): the rows split as
// evenly as they go, the first n_rows % n_ctas CTAs taking one more.
EH_PLAN_FN long long eh_plan_row_begin(long long n_rows, long long n_ctas,
                                       long long c) {
  const long long base = n_rows / n_ctas;
  const long long extra = n_rows % n_ctas;
  return c * base + (c < extra ? c : extra);
}

// Stages of at most k rows that cover the rows [begin, end).
EH_PLAN_FN long long eh_plan_stages(long long begin, long long end, long long k) {
  return (end - begin + k - 1) / k;
}

// The slot segment that starts at flat row g, cut at `end`: slot g / R,
// rows [g, min(end, (slot + 1) * R)).
struct EhSegment {
  long long slot, begin, end;
};

EH_PLAN_FN EhSegment eh_plan_segment(long long g, long long end, long long R) {
  const long long m = g / R;
  const long long e = (m + 1) * R;
  return EhSegment{m, g, e < end ? e : end};
}

// How the bytes [start, end) reach shared memory: a direct copy of the head
// [start, bulk_src), one bulk copy [bulk_src, bulk_src + bulk_bytes) whose
// source, size (and, at shared offset bulk_src - lo, destination) are
// 16-byte aligned, and a direct copy of the tail [tail_src, end). Shared
// memory holds global byte a at offset a - lo, lo = start rounded down to
// 16, so the bytes keep their alignment. The head and the tail are under 16
// bytes each.
struct EhSpan {
  unsigned long long start, lo, bulk_src, tail_src, end;
  unsigned long long head_bytes, bulk_bytes, tail_bytes;
};

EH_PLAN_FN EhSpan eh_plan_bytes(unsigned long long start, unsigned long long end) {
  EhSpan s;
  s.start = start;
  s.end = end;
  s.lo = s.start & ~15ull;
  const unsigned long long ib = (s.start + 15) & ~15ull;  // first aligned byte
  const unsigned long long ie = s.end & ~15ull;           // last aligned end
  if (ib < ie) {
    s.head_bytes = ib - s.start;
    s.bulk_src = ib;
    s.bulk_bytes = ie - ib;
    s.tail_src = ie;
    s.tail_bytes = s.end - ie;
  } else {  // no whole aligned 16-byte block: all of it is head
    s.head_bytes = s.end - s.start;
    s.bulk_src = s.end;
    s.bulk_bytes = 0;
    s.tail_src = s.end;
    s.tail_bytes = 0;
  }
  return s;
}

// The span of rows [g0, g1) of a stack at address `base` (rows of row_bytes
// bytes): one contiguous run of bytes.
EH_PLAN_FN EhSpan eh_plan_span(unsigned long long base, long long g0, long long g1,
                               long long row_bytes) {
  return eh_plan_bytes(base + static_cast<unsigned long long>(g0) * row_bytes,
                       base + static_cast<unsigned long long>(g1) * row_bytes);
}

// Rows wider than one CTA's column tile (max_cols) are split over a cluster
// of CTAs, each staging one column tile of the same rows: eh_plan_tiles
// CTAs, tile k holding columns [eh_plan_tile_begin(F, n, k),
// eh_plan_tile_begin(F, n, k + 1)). Every tile but the last is the same
// multiple of 4 columns wide, so a tile keeps a row's 16-byte alignment.
EH_PLAN_FN int eh_plan_tiles(long long F, long long max_cols) {
  return static_cast<int>((F + max_cols - 1) / max_cols);
}

EH_PLAN_FN long long eh_plan_tile_begin(long long F, int n_tiles, int k) {
  const long long w = ((F + n_tiles - 1) / n_tiles + 3) / 4 * 4;
  const long long b = k * w;
  return b < F ? b : F;
}

// CTAs in each reduction group. Where all the partials together are small
// (n_ctas * Fp <= kEhPlanOneLevelFloats floats), one group: the last CTA
// sums them all. Else about the square root of the grid, so the last CTA
// of a group and the last group each sum about sqrt(n_ctas) partials.
// Group j holds CTAs [j * size, min(n_ctas, (j + 1) * size)).
constexpr long long kEhPlanOneLevelFloats = 1 << 16;

EH_PLAN_FN int eh_plan_group_size(int n_ctas, long long Fp) {
  if (static_cast<long long>(n_ctas) * Fp <= kEhPlanOneLevelFloats) return n_ctas;
  int g = 1;
  while (static_cast<long long>(g) * g < n_ctas) ++g;
  return g;
}

EH_PLAN_FN int eh_plan_groups(int n_ctas, long long Fp) {
  const int g = eh_plan_group_size(n_ctas, Fp);
  return (n_ctas + g - 1) / g;
}
