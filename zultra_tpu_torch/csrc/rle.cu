// The Zopfli RLE decision sweep over histograms, and the RLE statistics of
// concatenated code-length tables, for a batch of rows of at most 320
// entries.
//
// Neither has a Pallas counterpart: they replace XLA programs of the JAX
// package's planner. rle_sweep_kernel is optimize_for_rle_jax
// (zultra_tpu/ops/entropy_jax.py:462-545, a lax.scan; reference
// huffutils.c:34-114); rle_stats_kernel is rle_histogram and rle_bits
// (entropy_jax.py:255 and :276, with _run_counts :202-252). Callers:
// ops/rle_cuda.py, from entropy_torch.optimize_for_rle (twice a planner
// call), _symbol_and_table_cost (every dynamic cost of the splitter and
// the planner) and mask_histograms / mask_search (20 masks a launch).
//
// What bounds them on the card: neither bytes nor arithmetic. A row is at
// most 1,280 bytes; the sweep is a dependent chain of up to 321 steps, the
// statistics a few dozen operations a run. On the path the launch and, for
// the sweep, the one thread's chain are the call.
//
// What the design does about it:
// - A warp a row, every row of the call in one launch (the plain form makes
//   about ten launches a step of the sweep, and the statistics a chain of
//   small ops a mask).
// - The parallel parts run warp-wide on registers and shared memory: run
//   starts by ballot (word k of the ballots holds positions 32k..32k+31),
//   each position's run from the starts around it, good-for-RLE and the
//   four-wide limits for every position at once.
// - The sweep runs on lane 0 with (stride, limit, total) in registers. It
//   reads only the original counts: a write decided at step i covers
//   [i - stride, i), behind the cursor, so lane 0 only records the
//   segments and the warp writes them after the sweep. It stops at eff: a
//   step past eff changes nothing.
// - The statistics: each run start computes its emission counts in closed
//   form (the reference walks them), the warp sums them into 19 bins by
//   shared atomics, or into one bit total by a warp reduction; adds wrap
//   mod 2^32 as the plain form's int32 sums do.
// ops/rle_cuda.py holds plain models of both schedules.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_L = 320;
constexpr int WORDS = MAX_L / WARP;      // ballot words of a row
constexpr int ROWS = 4;                  // warps (rows) a block
constexpr int MAX_SEGS = MAX_L / 3 + 2;  // a written segment spans >= 3 positions
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

// The highest start at or below i, from the ballot words (-1 if none).
__device__ __forceinline__ int prev_start(const unsigned* words, int i) {
  int k = i / WARP;
  const int lane = i % WARP;
  unsigned m = words[k] & (lane == WARP - 1 ? FULL : ((2u << lane) - 1u));
  while (m == 0 && k > 0) m = words[--k];
  return m ? k * WARP + 31 - __clz(m) : -1;
}

// The lowest start above i (-1 if none).
__device__ __forceinline__ int next_start(const unsigned* words, int i, int n_words) {
  int k = i / WARP;
  const int lane = i % WARP;
  unsigned m = lane == WARP - 1 ? 0u : words[k] & ~((2u << lane) - 1u);
  while (m == 0 && k + 1 < n_words) m = words[++k];
  return m ? k * WARP + __ffs(m) - 1 : -1;
}

// Ballot words of the run starts among positions < n of row `v` (the row
// also in shared memory, `row`): position 0, or a value other than the one
// before it.
__device__ __forceinline__ void start_words(const int* row, const int (&v)[WORDS], int n,
                                            unsigned* words, int lane) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    const bool s = i < n && (i == 0 || v[k] != row[i - 1]);
    const unsigned b = __ballot_sync(FULL, s);
    if (lane == 0) words[k] = b;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(ROWS * WARP)
    rle_sweep_kernel(const int32_t* __restrict__ counts, int32_t* __restrict__ out, int B,
                     int L) {
  __shared__ int c_s[ROWS][MAX_L + 4];
  __shared__ int lim_s[ROWS][MAX_L];
  __shared__ unsigned start_s[ROWS][WORDS];
  __shared__ unsigned good_s[ROWS][WORDS];
  __shared__ int seg_s[ROWS][MAX_SEGS][3];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int row_id = blockIdx.x * ROWS + warp;
  if (row_id >= B) return;  // the whole warp: no block-wide barrier below
  int* c = c_s[warp];
  const int32_t* g = counts + (size_t)row_id * L;

  int v[WORDS];
  int e = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    v[k] = i < L ? g[i] : 0;
    c[i] = v[k];
    if (v[k] != 0) e = i + 1;
  }
  if (lane < 4) c[MAX_L + lane] = 0;
  const int eff = __reduce_max_sync(FULL, e);
  __syncwarp();

  // Run starts within eff; good_for_rle: zero runs >= 5, nonzero >= 7.
  start_words(c, v, eff, start_s[warp], lane);
  const int n_words = (eff + WARP - 1) / WARP;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    bool good = false;
    if (i < eff) {
      const int s = prev_start(start_s[warp], i);
      const int ns = next_start(start_s[warp], i, n_words);
      const int run = (ns < 0 ? eff : ns) - s;
      good = run >= (v[k] == 0 ? 5 : 7);
    }
    const unsigned b = __ballot_sync(FULL, good);
    if (lane == 0) good_s[warp][k] = b;
    if (i < L) lim_s[warp][i] = floordiv(wrap_add(wrap_add(c[i], c[i + 1]),
                                                  wrap_add(wrap_add(c[i + 2], c[i + 3]), 2)),
                                         4);
  }
  __syncwarp();

  // The sweep over i = 0..eff on lane 0: segments [i - stride, i).
  int n_seg = 0;
  if (lane == 0) {
    const unsigned* good = good_s[warp];
    const int* lim4 = lim_s[warp];
    int stride = 0, limit = c[0], total = 0;
    for (int i = 0; i <= eff; ++i) {
      const bool inside = i < eff;
      const int ci = c[i];
      const bool gi = inside && ((good[i / WARP] >> (i % WARP)) & 1u);
      if (!inside || gi || abs(ci - limit) >= 4) {
        if (stride >= 4 || (stride >= 3 && total == 0)) {
          const int val =
              total == 0 ? 0 : max(floordiv(wrap_add(total, stride / 2), stride), 1);
          seg_s[warp][n_seg][0] = i - stride;
          seg_s[warp][n_seg][1] = i;
          seg_s[warp][n_seg][2] = val;
          ++n_seg;
        }
        limit = i < eff - 3 ? lim4[i] : (inside ? ci : 0);
        stride = 0;
        total = 0;
      }
      ++stride;
      if (inside) total = wrap_add(total, ci);
    }
  }
  n_seg = __shfl_sync(FULL, n_seg, 0);
  __syncwarp();

  // Rewrite the decided segments, then store the row.
  for (int s = 0; s < n_seg; ++s) {
    const int lo = seg_s[warp][s][0], hi = seg_s[warp][s][1], val = seg_s[warp][s][2];
    for (int p = lo + lane; p < hi; p += WARP) c[p] = val;
  }
  __syncwarp();
  int32_t* o = out + (size_t)row_id * L;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    if (i < L) o[i] = c[i];
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

// mode 0: out (M * B, 19) histograms; mode 1: out (M * B,) bit sizes under
// te (M * B, 19). Row m * B + b is lane b under masks.m[m].
__global__ void __launch_bounds__(ROWS * WARP)
    rle_stats_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ n_def,
                     const int32_t* __restrict__ te, int32_t* __restrict__ out, int B, int L,
                     int R, Masks masks, int mode) {
  __shared__ int row_s[ROWS][MAX_L];
  __shared__ unsigned start_s[ROWS][WORDS];
  __shared__ int bins_s[ROWS][NCL];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int r_id = blockIdx.x * ROWS + warp;
  if (r_id >= R) return;  // the whole warp: no block-wide barrier below
  const int b = r_id % B;
  const int mask = masks.m[r_id / B];
  const int nd = n_def[b];
  const int n = min(nd, L);
  int* row = row_s[warp];
  int* bins = bins_s[warp];
  const int32_t* g = lens + (size_t)b * L;

  int v[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    v[k] = i < L ? g[i] : 0;
    row[i] = v[k];
  }
  if (lane < NCL) bins[lane] = mode == 0 ? 0 : te[(size_t)r_id * NCL + lane];
  __syncwarp();
  start_words(row, v, n, start_s[warp], lane);
  const int n_words = (L + WARP - 1) / WARP;

  int n16 = 0, n17 = 0, n18 = 0, bits = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int i = lane + WARP * k;
    if (i < n && ((start_s[warp][k] >> lane) & 1u)) {
      const int ns = next_start(start_s[warp], i, n_words);
      const int end = ns < 0 ? nd : min(ns, nd);
      const RunCounts rc = run_counts(v[k], max(end - i, 1), mask);
      const int idx = min(max(rc.lit_v, 0), 15);
      n16 = wrap_add(n16, rc.n16);
      n17 = wrap_add(n17, rc.n17);
      n18 = wrap_add(n18, rc.n18);
      if (mode == 0) {
        atomicAdd(&bins[idx], rc.lit_c);
      } else {
        bits = (int)((unsigned)bits + (unsigned)rc.lit_c * (unsigned)bins[idx]);
      }
    }
  }
  n16 = (int)__reduce_add_sync(FULL, (unsigned)n16);
  n17 = (int)__reduce_add_sync(FULL, (unsigned)n17);
  n18 = (int)__reduce_add_sync(FULL, (unsigned)n18);
  if (mode == 0) {
    __syncwarp();
    if (lane < NCL) {
      const int extra = lane == 16 ? n16 : lane == 17 ? n17 : lane == 18 ? n18 : 0;
      out[(size_t)r_id * NCL + lane] = wrap_add(bins[lane], extra);
    }
  } else {
    bits = (int)__reduce_add_sync(FULL, (unsigned)bits);
    if (lane == 0) {
      const unsigned t = (unsigned)n16 * (unsigned)(bins[16] + 2) +
                         (unsigned)n17 * (unsigned)(bins[17] + 3) +
                         (unsigned)n18 * (unsigned)(bins[18] + 7);
      out[r_id] = (int)((unsigned)bits + t);
    }
  }
}

}  // namespace

extern "C" int zt_rle_sweep(const void* counts, void* out, int B, int L, void* stream) {
  if (L < 1 || L > MAX_L || B < 0) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    rle_sweep_kernel<<<(B + ROWS - 1) / ROWS, ROWS * WARP, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (int32_t*)out, B, L);
  }
  return (int)cudaGetLastError();
}

extern "C" int zt_rle_stats(const void* lens, const void* n_def, const void* te, void* out,
                            int B, int L, const int* masks, int M, int mode, void* stream) {
  if (L < 1 || L > MAX_L || B < 0 || M < 1 || M > MAX_MASKS || (mode != 0 && mode != 1) ||
      (mode == 1 && te == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Masks mk{};
  for (int i = 0; i < M; ++i) mk.m[i] = masks[i];
  const long long R = (long long)M * B;
  if (R > 0) {
    rle_stats_kernel<<<(unsigned)((R + ROWS - 1) / ROWS), ROWS * WARP, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lens, (const int32_t*)n_def, (const int32_t*)te, (int32_t*)out, B, L,
        (int)R, mk, mode);
  }
  return (int)cudaGetLastError();
}
