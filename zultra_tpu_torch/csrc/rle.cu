// The Zopfli RLE decision sweep over histograms, and the RLE statistics of
// concatenated code-length tables, for a batch of rows of at most 320
// entries.
//
// Neither has a Pallas counterpart: they replace XLA programs of the JAX
// package's planner. rle_sweep_kernel is optimize_for_rle_jax
// (zultra_tpu/ops/entropy_jax.py:462-545, a lax.scan; reference
// huffutils.c:34-114); rle_stats_kernel is _concat_lengths (:568) followed
// by rle_histogram and rle_bits (:255 and :276, with _run_counts
// :202-252), which XLA fuses into one program. Callers: ops/rle_cuda.py,
// from entropy_torch.optimize_for_rle (twice a planner call),
// _symbol_and_table_cost (every dynamic cost of the splitter and the
// planner: one mask a launch) and mask_histograms / mask_search (20 masks
// a launch).
//
// What bounds them on the card: neither bytes nor arithmetic. A row is at
// most 1,280 bytes; the sweep is a dependent chain of up to 321 steps, the
// statistics a few dozen operations a run. On the path the launch, one
// load's latency and, for the sweep, the chain are the call. Taken a step
// at a time, the sweep's chain costs several dependent operations a step,
// and a row's ten words of parallel work (run starts, limits, sums,
// segments) on one warp cost as much again: a warp a row took 8.2-8.7 us
// a row of 288 on an H100 (PERF.md).
//
// What the design does about it:
// - Every row of the call in one launch (the plain form makes about ten
//   launches a step of the sweep, and the statistics a chain of small ops
//   a mask); the sweep takes both row sets of a planner call (the
//   literal/length and the offset histograms) in one grid. The
//   statistics take a warp a row; the sweep a warp for each word of 32
//   counts (a block a row of 288, ten rows of 32 a block), the words of a
//   row meeting in shared memory.
// - The sweep's parallel parts run on each word's warp: run starts by
//   ballot, each position's run from the nearest starts (in its word by a
//   bit search, else from the other words' ballots), good-for-RLE, each
//   step's inputs (the count, the limit a boundary there sets) and the
//   prefix sums of the counts.
// - The chain carries the limit alone: a boundary at i is good[i] or
//   |c[i] - limit| >= 4 and sets the limit to step i's; stride and total
//   only matter at boundaries and follow from them. Since a boundary's
//   limit is step i's own, the boundaries after one inside its word do
//   not depend on the limit the word was entered with: every lane finds
//   the next boundary after itself (32 tests, broadcast loads of the
//   word's counts) and the path of boundaries from itself on (pointer
//   doubling, five shuffle rounds), every word on its own warp. What
//   stays serial is a word's entry, on the row's first warp with every
//   word's inputs in registers: a test a lane under the entering limit, a
//   ballot, the path from the lowest hit by a shuffle, the limit of its
//   last lane by another: about ten dependent operations a word in place
//   of 32 steps of four. It stops at eff: a step past eff changes
//   nothing.
// - Then every position finds its segment [s, e) between the boundaries
//   around it (0 and eff at the ends), its total as a difference of the
//   wrapping prefix sums (equal to the chain of wrapping adds), and is
//   rewritten to the segment's mean when the segment is written. Every
//   decision reads the original counts, as the reference's writes land
//   behind its cursor.
// - The statistics take the code lengths themselves (lit_len, off_len) and
//   concatenate them in registers: n_lit and n_off by warp-wide max
//   reductions, off moved into place by one shuffle a word. A lane's runs
//   are found once for all its masks: the starts by ballot, each start's
//   end from the next set bit of its word or the first start of the next
//   nonzero word (one shuffle), the runs compacted in order into shared
//   memory. One mask: a warp a lane, 32 runs a step, each run's counts in
//   closed form (the reference walks them), the 19 bins packed three to a
//   register and summed by seven warp reductions (equal symbols
//   aggregated by __match_any_sync first where the packing could
//   overflow, or for measurement), the bit size by one reduction with the
//   CL lengths in registers, gathered by shuffle. Several masks:
//   a block a lane, a thread a run, each run's counts under every class
//   of masks that can differ for it (5 for a nonzero run, 4 for zeros),
//   then each mask's row read from its two classes. Adds wrap mod 2^32 as
//   the plain form's int32 sums do.
// ops/rle_cuda.py holds plain models of both schedules.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_L = 320;
constexpr int WORDS = MAX_L / WARP;      // ballot words of a row
constexpr int MAX_MASKS = 32;
constexpr int NCL = 19;                  // CL alphabet
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Masks {
  int m[MAX_MASKS];
};

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0, as Python's //
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// |a - b| in int32 arithmetic, which wraps (|INT32_MIN| stays negative).
__device__ __forceinline__ int wrap_dist(int a, int b) {
  const unsigned d = (unsigned)a - (unsigned)b;
  return (int)d < 0 ? (int)(0u - d) : (int)d;
}

// Lanes 0..lane of a ballot word.
__device__ __forceinline__ unsigned at_or_below(int lane) {
  return lane == WARP - 1 ? FULL : (2u << lane) - 1u;
}

// The nearest set position at or below 32 k + lane, and above it.
__device__ __forceinline__ int set_at_or_below(unsigned m, int k, int lane, int below) {
  const unsigned x = m & at_or_below(lane);
  return x ? WARP * k + 31 - __clz(x) : below;
}

__device__ __forceinline__ int set_above(unsigned m, int k, int lane, int above) {
  const unsigned x = m & ~at_or_below(lane);
  return x ? WARP * k + __ffs(x) - 1 : above;
}

constexpr int SWEEP_WARPS = WORDS;  // warps a block: a row takes a warp a word of 32 counts

// The rows of two sets (a: Ba rows of La, b: Bb rows of Lb) in one grid,
// set a's blocks first. A row of L counts takes R = ceil(L / 32) warps,
// warp w of the row holding positions 32 w .. 32 w + 31, a position in
// its lane; a block holds SWEEP_WARPS / R rows of one set. Shared arrays
// are indexed by the position in the block, 32 * warp + lane, so a row's
// positions are contiguous from its first warp's.
__global__ void __launch_bounds__(SWEEP_WARPS * WARP)
    rle_sweep_kernel(const int32_t* __restrict__ ca, int32_t* __restrict__ oa, int Ba, int La,
                     const int32_t* __restrict__ cb, int32_t* __restrict__ ob, int Bb, int Lb) {
  __shared__ int c_s[MAX_L];       // the counts
  __shared__ int lim_s[MAX_L];     // the limit a boundary at each position sets
  __shared__ int pre_s[MAX_L];     // sum of the row's counts before each position, wrapping
  __shared__ unsigned path_s[MAX_L];  // the boundaries from each position on, in its word
  __shared__ int eff_s[SWEEP_WARPS], sum_s[SWEEP_WARPS], total_s[SWEEP_WARPS];
  __shared__ unsigned start_s[SWEEP_WARPS], good_s[SWEEP_WARPS], bnd_s[SWEEP_WARPS];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int Ra = (La + WARP - 1) / WARP, blocks_a = (Ba + SWEEP_WARPS / Ra - 1) / (SWEEP_WARPS / Ra);
  const bool in_a = (int)blockIdx.x < blocks_a;
  const int L = in_a ? La : Lb, R = (L + WARP - 1) / WARP, per_block = SWEEP_WARPS / R;
  const int slot = warp / R, word = warp % R;  // the block's row, the row's word
  const int row = ((int)blockIdx.x - (in_a ? 0 : blocks_a)) * per_block + slot;
  const bool active = slot < per_block && row < (in_a ? Ba : Bb);  // the same over the warp
  const int first_warp = slot * R, base = WARP * first_warp;  // the row's first warp, position
  const int i = WARP * word + lane, at = WARP * warp + lane;  // at == base + i
  const size_t g = (size_t)row * L + i;

  int v = active && i < L ? (in_a ? ca : cb)[g] : 0;
  c_s[at] = v;
  const int e = __reduce_max_sync(FULL, v != 0 ? i + 1 : 0);
  if (lane == 0) eff_s[warp] = e;
  __syncthreads();
  int eff = 0;
  for (int q = 0; active && q < R; ++q) eff = max(eff, eff_s[first_warp + q]);

  // Run starts within eff (position 0, or a value other than the one
  // before); each step's limit (the four-wide mean below eff - 3, else
  // c[i]); the counts' sums over the word.
  const bool starts = active && i < eff && (i == 0 || v != c_s[at - 1]);
  const unsigned start = __ballot_sync(FULL, starts);
  unsigned sum4 = (unsigned)v + 2u;
#pragma unroll
  for (int d = 1; d <= 3; ++d) sum4 += i + d < L ? (unsigned)c_s[at + d] : 0u;
  const int after = i < eff - 3 ? (int)sum4 >> 2 : v;  // >> 2: floor / 4
  lim_s[at] = after;
  unsigned x = (unsigned)v;
#pragma unroll
  for (int d = 1; d < WARP; d <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 0) start_s[warp] = start;
  if (lane == WARP - 1) sum_s[warp] = (int)x;
  __syncthreads();

  // good_for_rle: a zero run of >= 5 or a nonzero run of >= 7, each
  // position's run from the nearest starts (the other words' by their
  // ballots); the prefix sums.
  int s_below = 0, s_above = eff;
  unsigned carry = 0;
  for (int q = 0; active && q < R; ++q) {
    const unsigned m = start_s[first_warp + q];
    if (q < word && m) s_below = WARP * q + 31 - __clz(m);
    if (q < word) carry += (unsigned)sum_s[first_warp + q];
  }
  for (int q = R - 1; active && q > word; --q) {
    const unsigned m = start_s[first_warp + q];
    if (m) s_above = WARP * q + __ffs(m) - 1;
  }
  const int run = set_above(start, word, lane, s_above) - set_at_or_below(start, word, lane, s_below);
  const unsigned good = __ballot_sync(FULL, active && i < eff && run >= (v == 0 ? 5 : 7));
  pre_s[at] = (int)(carry + x - (unsigned)v);
  if (lane == 0) good_s[warp] = good;
  if (active && word == R - 1 && lane == WARP - 1) total_s[slot] = (int)(carry + x);

  // The chain, a word of 32 steps at a time. A boundary at i is good[i]
  // or |c[i] - limit| >= 4 (int32, wrapping as the plain form's abs), and
  // sets the limit to step i's; so within a word the boundaries after a
  // boundary at lane i follow from i alone: next_i, the first lane j > i
  // that is a boundary under limit lim_i, found by 32 tests a lane, and
  // path_i, the boundaries from i on, by pointer doubling over next (five
  // rounds: at most 32 boundaries a word). Neither waits on the limit a
  // word is entered with, and every word of the row runs on its own warp.
  const int left = eff - WARP * word;
  if (active && left > 0) {
    const unsigned live = left >= WARP ? FULL : (1u << left) - 1u;
    unsigned hits = 0;
#pragma unroll
    for (int j = 0; j < WARP; ++j) {
      hits |= (unsigned)(wrap_dist(c_s[WARP * warp + j], after) >= 4) << j;
    }
    hits = (hits | good) & live & ~at_or_below(lane);
    int next = hits ? __ffs(hits) - 1 : WARP;
    unsigned path = 1u << lane;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const unsigned further = __shfl_sync(FULL, path, next % WARP);
      const int then = __shfl_sync(FULL, next, next % WARP);
      if (next < WARP) path |= further, next = then;
    }
    path_s[at] = path;
  }
  __syncthreads();

  // The words in order, on the row's first warp, every word's counts,
  // good bits, paths and limits first loaded into registers: under the
  // entering limit each lane tests its own step, the lowest that is a
  // boundary starts the word's path, and the path's last lane sets the
  // limit the next word is entered with.
  if (active && word == 0) {
    int cw[WORDS], lw[WORDS];
    unsigned pw[WORDS], gw[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const bool in = WARP * k < eff;
      cw[k] = in ? c_s[base + WARP * k + lane] : 0;
      lw[k] = in ? lim_s[base + WARP * k + lane] : 0;
      pw[k] = in ? path_s[base + WARP * k + lane] : 0u;
      gw[k] = in ? good_s[first_warp + k] : 0u;
    }
    int limit = __shfl_sync(FULL, cw[0], 0);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      unsigned bits = 0;
      if (WARP * k < eff) {
        const bool hit = lane < eff - WARP * k &&
                         (((gw[k] >> lane) & 1u) || wrap_dist(cw[k], limit) >= 4);
        const unsigned first = __ballot_sync(FULL, hit);
        bits = __shfl_sync(FULL, pw[k], first ? __ffs(first) - 1 : 0);
        const int lim = __shfl_sync(FULL, lw[k], 31 - __clz(bits | 1u));
        if (first) {
          limit = lim;
        } else {
          bits = 0;
        }
      }
      if (lane == 0 && k < R) bnd_s[first_warp + k] = bits;
    }
  }
  __syncthreads();

  // The segments, every position at once: position i < eff lies in
  // [s, e), s the last boundary at or below it (or 0), e the first above
  // it (or eff); the segment is written when stride = e - s >= 4, or >= 3
  // with a zero total, with its rounded mean (at least 1) or 0.
  if (active && i < L) {
    int out = v;
    if (i < eff) {
      int b_below = 0, b_above = eff;
      for (int q = 0; q < word; ++q) {
        const unsigned m = bnd_s[first_warp + q];
        if (m) b_below = WARP * q + 31 - __clz(m);
      }
      for (int q = R - 1; q > word; --q) {
        const unsigned m = bnd_s[first_warp + q];
        if (m) b_above = WARP * q + __ffs(m) - 1;
      }
      const unsigned bw = bnd_s[warp];
      const int s = set_at_or_below(bw, word, lane, b_below);
      const int e2 = set_above(bw, word, lane, b_above);
      const int stride = e2 - s;
      const unsigned pe = e2 < WARP * R ? (unsigned)pre_s[base + e2] : (unsigned)total_s[slot];
      const int total = (int)(pe - (unsigned)pre_s[base + s]);
      if (stride >= 4 || (stride >= 3 && total == 0)) {
        out = total == 0 ? 0 : max(floordiv(wrap_add(total, stride / 2), stride), 1);
      }
    }
    (in_a ? oa : ob)[g] = out;
  }
}

// One run's emission counts under `mask` (walk_var_lengths), in closed
// form: n16, n17, n18, the literal count and the literal's CL symbol.
struct RunCounts {
  int n16, n17, n18, lit_c, lit_v;
};

__device__ __forceinline__ RunCounts run_counts(int value, int r, int mask) {
  RunCounts rc{0, 0, 0, 0, 0};
  if (value == 0) {
    int after = r;
    if ((mask & 4) && r >= 11) {
      const int rem = r % 138;
      rc.n18 = r / 138 + (rem >= 11);
      after = rem >= 11 ? 0 : rem;
    }
    if ((mask & 2) && r >= 3 && after >= 3) {
      const int rem = after % 10;
      rc.n17 = after / 10 + (rem >= 3);
      after = rem >= 3 ? 0 : rem;
    }
    rc.lit_c = after;
    return rc;
  }
  const int rp = r - 1;
  int left = rp;
  if (mask & 1) {
    if ((rp == 7 && !(mask & 8)) || (rp == 8 && !(mask & 16))) {
      rc.n16 = 2;
      left = 0;
    } else {
      const int rem = rp % 6;
      rc.n16 = rp / 6 + (rem >= 3);
      left = rem < 3 ? rem : 0;
    }
  }
  rc.lit_c = 1 + left;
  rc.lit_v = min(value, 15);
  return rc;
}

// The C entry's arguments. A lane's row is lit[b, :n_lit] ++ off[b, :n_off]
// with n_lit = max(last nonzero of lit[b] + 1, min_lit) and n_off likewise
// (entropy_jax._concat_lengths :568, defined_count :307); the fused calls
// pass lit_len (B, 288) and off_len (B, 32) with min_lit 257 and min_off 1.
// Rows already concatenated pass lens as lit with min_lit = L_lit, no off
// (L_off = min_off = 0) and n_def; with n_def null it is n_lit + n_off.
struct StatsArgs {
  const int32_t* lit;
  const int32_t* off;
  const int32_t* n_def;  // (B,) or null
  const int32_t* te;     // (M * B, 19) CL code lengths (mode 1)
  int32_t* out;          // mode 0: (M * B, 19) histograms; mode 1: (M * B,) bit sizes
  int32_t* n_lit_out;    // (B,) or null
  int32_t* n_off_out;    // (B,) or null
  int L_lit, min_lit, L_off, min_off, B, M, mode;
  Masks masks;
};

// A run as find_runs stores it: (its length, its value clamped to 0..15, or
// ZERO_RUN for a run of zeros).
constexpr int ZERO_RUN = 16;

// Lane b's runs into `runs` (in order of position), by one warp; returns
// their number (and the lane's n_def in nd_out). Lane j holds positions j + 32 k. All of the row's loads
// are issued before the first use: lit[i] and lit[i - 1], which give a
// start without a shuffle, and off[j] (a shuffle moves it to position
// n_lit + j, only in the words that reach n_lit). The start ballots are
// the same in every lane, so each lane finds the first start past each
// word itself; a start's end is the next set bit of its word or that.
__device__ __forceinline__ int find_runs(const StatsArgs& a, int b, int lane, int2* runs,
                                         int& nd_out) {
  const int32_t* lit = a.lit + (size_t)b * a.L_lit;
  int cur[WORDS], prev[WORDS];  // lit[i], lit[i - 1]
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    cur[k] = i < a.L_lit ? lit[i] : 0;
    prev[k] = i >= 1 && i <= a.L_lit ? lit[i - 1] : 0;
  }
  const int ov = lane < a.L_off ? a.off[(size_t)b * a.L_off + lane] : 0;
  const int nd_given = a.n_def ? a.n_def[b] : 0;
  int last = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    if (cur[k] != 0) last = lane + WARP * k + 1;
  }
  const int n_lit = max(__reduce_max_sync(FULL, last), a.min_lit);
  const int n_off = max(__reduce_max_sync(FULL, ov != 0 ? lane + 1 : 0), a.min_off);
  const int nd = a.n_def ? nd_given : n_lit + n_off;
  const int n = min(nd, n_lit + n_off);  // positions that can start a run
  nd_out = nd;
  if (lane == 0 && a.n_lit_out) {
    a.n_lit_out[b] = n_lit;
    a.n_off_out[b] = n_off;
  }

  unsigned words[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    if (WARP * k + WARP > n_lit) {  // uniform: the word reaches the offsets
      const int j = i - n_lit;      // position n_lit + j holds off[j]
      const int o = __shfl_sync(FULL, ov, j & (WARP - 1));
      const int o_prev = __shfl_sync(FULL, ov, (j - 1) & (WARP - 1));
      if (j >= 0) {
        cur[k] = j < n_off ? o : 0;
        if (j > 0) prev[k] = o_prev;  // j == 0: lit[n_lit - 1]
      }
    }
    words[k] = __ballot_sync(FULL, i < n && (i == 0 || cur[k] != prev[k]));
  }
  int after[WORDS];  // the first start past word k, or -1
  int next = -1;
#pragma unroll
  for (int k = WORDS - 1; k >= 0; --k) {
    after[k] = next;
    if (words[k]) next = WARP * k + __ffs(words[k]) - 1;
  }

  int n_runs = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    if ((words[k] >> lane) & 1u) {
      const unsigned rest = words[k] & ~((2u << lane) - 1u);  // starts above i in word k
      const int e = rest ? WARP * k + __ffs(rest) - 1 : after[k];
      const int end = e < 0 ? nd : min(e, nd);
      const int value = cur[k];
      const int sym = value == 0 ? ZERO_RUN : min(max(value, 0), 15);
      runs[n_runs + __popc(words[k] & ((1u << lane) - 1u))] = make_int2(max(end - i, 1), sym);
    }
    n_runs += __popc(words[k]);
  }
  return n_runs;
}

// One run's counts under `mask` (run_counts), lit_v its CL symbol.
__device__ __forceinline__ RunCounts counts_of(int2 run, int mask) {
  const bool zero = run.y == ZERO_RUN;
  RunCounts rc = run_counts(zero ? 0 : 1, run.x, mask);  // the counts see zero or not
  rc.lit_v = zero ? 0 : run.y;
  return rc;
}

// Lane b's row of one mask over its `n_runs` runs, lane j of the warp
// taking runs j, j + 32, ...; te_lane is te[b][lane] for lane < 19 (mode
// 1). Mode 0 sums the 19 bins packed three to a register in 10-bit fields,
// one warp reduction a register: exact while the bins' total is below
// 1024, and it is at most nd (every code it counts covers a position). A
// lane with nd past that (rows already concatenated with a large n_def)
// aggregates the lanes of equal symbol (__match_any_sync) into the warp's
// shared bins instead. Mode 1: one bit total, the CL
// lengths gathered by shuffle.
constexpr int PACK_BITS = 10;
constexpr int PACKED = (NCL + 2) / 3;  // registers of three bins

__device__ __forceinline__ void stats_row(const StatsArgs& a, const int2* runs, int n_runs,
                                          int nd, int b, int te_lane, int* bins, int lane) {
  const int mask = a.masks.m[0];
  const bool packed = nd < (1 << PACK_BITS);
  unsigned acc[PACKED];
#pragma unroll
  for (int r = 0; r < PACKED; ++r) acc[r] = 0;
  unsigned n16 = 0, n17 = 0, n18 = 0, bits = 0;
  if (a.mode == 0 && !packed) {
    if (lane < 16) bins[lane] = 0;
    __syncwarp();
  }
  const unsigned t16 = (unsigned)__shfl_sync(FULL, te_lane, 16) + 2u;
  const unsigned t17 = (unsigned)__shfl_sync(FULL, te_lane, 17) + 3u;
  const unsigned t18 = (unsigned)__shfl_sync(FULL, te_lane, 18) + 7u;
  for (int base = 0; base < n_runs; base += WARP) {  // uniform over the warp
    const int j = base + lane;
    RunCounts rc{0, 0, 0, 0, 0};
    if (j < n_runs) rc = counts_of(runs[j], mask);
    const int sym = rc.lit_v;
    if (a.mode == 1) {
      const unsigned t = (unsigned)__shfl_sync(FULL, te_lane, sym);
      bits += (unsigned)rc.lit_c * t + (unsigned)rc.n16 * t16 + (unsigned)rc.n17 * t17 +
              (unsigned)rc.n18 * t18;
    } else if (packed) {
      const int q = sym / 3;
      const unsigned add = (unsigned)rc.lit_c << (PACK_BITS * (sym - 3 * q));
#pragma unroll
      for (int r = 0; r < 16 / 3 + 1; ++r) acc[r] += q == r ? add : 0u;  // symbols 0..15
      acc[16 / 3] += ((unsigned)rc.n16 << PACK_BITS) + ((unsigned)rc.n17 << (2 * PACK_BITS));
      acc[18 / 3] += (unsigned)rc.n18;
    } else {
      n16 += (unsigned)rc.n16;
      n17 += (unsigned)rc.n17;
      n18 += (unsigned)rc.n18;
      const int key = j < n_runs ? sym : -1;
      const unsigned group = __match_any_sync(FULL, key);
      const unsigned sum = __reduce_add_sync(group, (unsigned)rc.lit_c);
      if (key >= 0 && lane == __ffs(group) - 1) bins[sym] = wrap_add(bins[sym], (int)sum);
      __syncwarp();  // the next step's leaders read these bins
    }
  }
  if (a.mode == 1) {
    bits = __reduce_add_sync(FULL, bits);
    if (lane == 0) a.out[b] = (int)bits;
    return;
  }
  unsigned mine = 0;  // lane j < 19: bin j
  if (packed) {
#pragma unroll
    for (int r = 0; r < PACKED; ++r) {
      const unsigned total = __reduce_add_sync(FULL, acc[r]);
      if (lane / 3 == r) mine = (total >> (PACK_BITS * (lane % 3))) & ((1u << PACK_BITS) - 1u);
    }
  } else {
    n16 = __reduce_add_sync(FULL, n16);
    n17 = __reduce_add_sync(FULL, n17);
    n18 = __reduce_add_sync(FULL, n18);
    __syncwarp();
    mine = lane < 16 ? (unsigned)bins[lane] : lane == 16 ? n16 : lane == 17 ? n17 : n18;
  }
  if (lane < NCL) a.out[(size_t)b * NCL + lane] = (int)mine;
}

// One mask (every dynamic cost): a warp a lane, LANE_ROWS lanes a block.
// The warp finds the lane's runs into shared memory and takes them 32 a
// step (stats_row). Output row b.
constexpr int LANE_ROWS = 4;

__global__ void __launch_bounds__(LANE_ROWS * WARP) rle_stats_kernel(const StatsArgs a) {
  __shared__ int2 runs_s[LANE_ROWS][MAX_L];
  __shared__ int bins_s[LANE_ROWS][16];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int b = blockIdx.x * LANE_ROWS + warp;
  if (b >= a.B) return;  // the whole warp: no block-wide barrier below
  const int te_lane = a.mode == 1 && lane < NCL ? a.te[(size_t)b * NCL + lane] : 0;
  int nd;
  const int n_runs = find_runs(a, b, lane, runs_s[warp], nd);
  __syncwarp();
  stats_row(a, runs_s[warp], n_runs, nd, b, te_lane, bins_s[warp], lane);
}

// Several masks (the mask search): a block a lane. A run's counts depend on
// the mask only through the bits its kind reads: a nonzero run through bits
// 1, 8 and 16 (five classes: no bit 1, or bit 1 with each pair of bits 8
// and 16), a run of zeros through bits 2 and 4 (four classes). Warp 0
// finds the runs; the block's threads take the (class, run) pairs and add
// each run's counts under each class of its kind (run_counts, the closed
// form, once a pair) into shared sums: literal counts by class and CL
// symbol, n16 by class, the zero runs' (count, n17, n18) by class. Then
// warp w takes masks w, w +
// MASK_WARPS, ...: lane j < 19 reads bin j of the mask's two classes; the
// bit size is their dot product with the CL lengths (te rows loaded before
// the first barrier), one reduction.
constexpr int MASK_WARPS = MAX_L / WARP;
constexpr int NZ_CLASSES = 5;
constexpr int Z_CLASSES = 4;

__device__ __forceinline__ int nonzero_class(int mask) {
  return mask & 1 ? 1 + ((mask >> 3) & 1) + 2 * ((mask >> 4) & 1) : 0;
}

__device__ __forceinline__ int nonzero_class_mask(int c) {  // a mask of class c
  return c == 0 ? 0 : 1 | ((c - 1) & 1 ? 8 : 0) | ((c - 1) & 2 ? 16 : 0);
}

__global__ void __launch_bounds__(MASK_WARPS * WARP) rle_stats_masks_kernel(const StatsArgs a) {
  constexpr int PER_WARP = (MAX_MASKS + MASK_WARPS - 1) / MASK_WARPS;
  constexpr int SUMS = NZ_CLASSES + 3 * Z_CLASSES;  // n16 by class; (count, n17, n18) by class
  __shared__ int2 runs_s[MAX_L];
  __shared__ int n_runs_s;
  __shared__ int lit_s[NZ_CLASSES][16];
  __shared__ int sums_s[SUMS];
  const int tid = threadIdx.x;
  const int warp = tid / WARP;
  const int lane = tid % WARP;
  const int b = blockIdx.x;

  int te_r[PER_WARP];
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int m = warp + i * MASK_WARPS;
    te_r[i] = a.mode == 1 && m < a.M && lane < NCL ? a.te[((size_t)m * a.B + b) * NCL + lane]
                                                    : 0;
  }
  for (int i = tid; i < NZ_CLASSES * 16 + SUMS; i += MASK_WARPS * WARP) {
    if (i < NZ_CLASSES * 16) {
      lit_s[i / 16][i % 16] = 0;
    } else {
      sums_s[i - NZ_CLASSES * 16] = 0;
    }
  }
  if (warp == 0) {
    int nd;
    const int n_runs = find_runs(a, b, lane, runs_s, nd);
    if (lane == 0) n_runs_s = n_runs;
  }
  __syncthreads();

  // (class, run) pairs over the block's threads, class-major; shared adds.
  const int n_runs = n_runs_s;
  for (int p = tid; p < NZ_CLASSES * n_runs; p += MASK_WARPS * WARP) {
    const int c = p / n_runs;
    const int2 run = runs_s[p - c * n_runs];
    if (run.y == ZERO_RUN) {
      if (c < Z_CLASSES) {
        const RunCounts rc = run_counts(0, run.x, c << 1);
        int* z = sums_s + NZ_CLASSES + 3 * c;
        if (rc.lit_c) atomicAdd(z, rc.lit_c);
        if (rc.n17) atomicAdd(z + 1, rc.n17);
        if (rc.n18) atomicAdd(z + 2, rc.n18);
      }
    } else {
      const RunCounts rc = run_counts(1, run.x, nonzero_class_mask(c));
      atomicAdd(&lit_s[c][run.y], rc.lit_c);
      if (rc.n16) atomicAdd(&sums_s[c], rc.n16);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int m = warp + i * MASK_WARPS;
    if (m >= a.M) break;  // uniform over the warp
    const int mask = a.masks.m[m];
    const int nc = nonzero_class(mask);
    const int zc = NZ_CLASSES + 3 * ((mask >> 1) & 3);
    unsigned v = 0;  // lane j < 19: bin j
    if (lane < 16) {
      v = (unsigned)lit_s[nc][lane] + (lane == 0 ? (unsigned)sums_s[zc] : 0u);
    } else if (lane < NCL) {
      v = (unsigned)(lane == 16 ? sums_s[nc] : sums_s[zc + lane - 16]);
    }
    const int row = m * a.B + b;
    if (a.mode == 0) {
      if (lane < NCL) a.out[(size_t)row * NCL + lane] = (int)v;
    } else {
      const unsigned t = (unsigned)te_r[i] + (lane == 16 ? 2u : lane == 17 ? 3u : lane == 18 ? 7u : 0u);
      const unsigned bits = __reduce_add_sync(FULL, lane < NCL ? v * t : 0u);
      if (lane == 0) a.out[row] = (int)bits;
    }
  }
}

}  // namespace

// Two sets of rows in one launch: Ba rows of La counts and Bb rows of Lb
// (Bb 0 for one set).
extern "C" int zt_rle_sweep(const void* ca, void* oa, int Ba, int La, const void* cb, void* ob,
                            int Bb, int Lb, void* stream) {
  if (Ba < 0 || Bb < 0 || La < 1 || La > MAX_L || (Bb > 0 && (Lb < 1 || Lb > MAX_L))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_a = SWEEP_WARPS / ((La + WARP - 1) / WARP);
  const long long per_b = Bb > 0 ? SWEEP_WARPS / ((Lb + WARP - 1) / WARP) : 1;
  const long long blocks = (Ba + per_a - 1) / per_a + (Bb + per_b - 1) / per_b;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    rle_sweep_kernel<<<(unsigned)blocks, SWEEP_WARPS * WARP, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ca, (int32_t*)oa, Ba, La, (const int32_t*)cb, (int32_t*)ob, Bb, Lb);
  }
  return (int)cudaGetLastError();
}

extern "C" int zt_rle_stats(const void* lit, const void* off, const void* n_def, const void* te,
                            void* out, void* n_lit_out, void* n_off_out, int L_lit, int min_lit,
                            int L_off, int min_off, int B, const int* masks, int M, int mode,
                            void* stream) {
  if (L_lit < 1 || L_off < 0 || L_off > WARP || L_lit + L_off > MAX_L || min_lit < 0 ||
      min_lit > L_lit || min_off < 0 || min_off > L_off ||
      B < 0 || M < 1 || M > MAX_MASKS || (mode != 0 && mode != 1) ||
      (mode == 1 && te == nullptr) || ((n_lit_out == nullptr) != (n_off_out == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  StatsArgs a{(const int32_t*)lit, (const int32_t*)off, (const int32_t*)n_def,
              (const int32_t*)te, (int32_t*)out, (int32_t*)n_lit_out, (int32_t*)n_off_out,
              L_lit, min_lit, L_off, min_off, B, M, mode, {}};
  for (int i = 0; i < M; ++i) a.masks.m[i] = masks[i];
  if (B > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (M > 1) {
      rle_stats_masks_kernel<<<(unsigned)B, MASK_WARPS * WARP, 0, st>>>(a);
    } else {
      rle_stats_kernel<<<(unsigned)((B + LANE_ROWS - 1) / LANE_ROWS), LANE_ROWS * WARP, 0, st>>>(
          a);
    }
  }
  return (int)cudaGetLastError();
}
