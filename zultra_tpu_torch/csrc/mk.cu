// Moffat-Katajainen phases 1-2 and Kraft-sum length limiting for a batch
// of Huffman alphabets: one lane per alphabet, S <= 288 symbols.
//
// Replaces the TPU kernels zultra_tpu/ops/mk_pallas.py::_mk12_kernel (the
// in-place two-queue merge and parent-chain depths of reference
// src/huffman/huffencoder.c:157-270) and ::_kraft_kernel (the Kraft repair
// of :279-346). Callers: entropy_torch.mk_lengths and limited_lengths, from
// the block splitter's MK costs, every Huffman build of the block planner
// and the CL-mask search.
//
// What bounds them on the card: neither bytes nor arithmetic. Each lane is
// a dependent chain of about S steps (MK: two queue-head picks per merge
// step, each a data-dependent read of the working array, then the parent
// chain; Kraft: a carried Kraft sum through a lengthen and a shorten
// sweep). The arrays are a few MB at most, so the time is the chain's
// latency, about S times a shared-memory round trip and a few ALU ops.
//
// Design: one thread per lane, 32 lanes (one warp) per block. The block
// copies its 32 rows into shared memory, laid out [s][lane] so that each
// thread's data-dependent index always falls in its own bank; the copy
// goes through a padded 32 x 33 tile, so global reads stay coalesced and
// shared stores stay free of bank conflicts. Each lane walks its array in
// shared memory and stops at its own n_used; the block copies the rows
// back. At S <= 288 the array is 288 * 32 * 4 = 36,864 B (41,088 B with
// the tile), under the 48 KB static limit. Lanes past B are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int MAX_S = 288;

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(max(x, 1)); }

// a[s][lane] = src[lane0 + lane][s] for the block's nl rows.
__device__ void load_rows(int32_t (*a)[LANES], int32_t (*tile)[LANES + 1],
                          const int32_t* __restrict__ src, int lane0, int nl, int S) {
  const int t = threadIdx.x;
  for (int s0 = 0; s0 < S; s0 += LANES) {
    for (int r = 0; r < nl; ++r) {
      if (s0 + t < S) tile[r][t] = src[(size_t)(lane0 + r) * S + s0 + t];
    }
    __syncthreads();
    const int cols = min(LANES, S - s0);
    for (int c = 0; c < cols; ++c) a[s0 + c][t] = tile[t][c];
    __syncthreads();
  }
}

// dst[lane0 + lane][s] = a[s][lane] for the block's nl rows.
__device__ void store_rows(int32_t* __restrict__ dst, int32_t (*a)[LANES],
                           int32_t (*tile)[LANES + 1], int lane0, int nl, int S) {
  const int t = threadIdx.x;
  for (int s0 = 0; s0 < S; s0 += LANES) {
    const int cols = min(LANES, S - s0);
    for (int c = 0; c < cols; ++c) tile[t][c] = a[s0 + c][t];
    __syncthreads();
    for (int r = 0; r < nl; ++r) {
      if (s0 + t < S) dst[(size_t)(lane0 + r) * S + s0 + t] = tile[r][t];
    }
    __syncthreads();
  }
}

__global__ void mk12_kernel(const int32_t* __restrict__ a0, const int32_t* __restrict__ n_used,
                            int32_t* __restrict__ out, int B, int S) {
  __shared__ int32_t a[MAX_S][LANES];
  __shared__ int32_t tile[LANES][LANES + 1];
  const int lane0 = blockIdx.x * LANES;
  const int nl = min(LANES, B - lane0);
  const int l = threadIdx.x;
  load_rows(a, tile, a0, lane0, nl, S);
  if (l < nl) {
    const int n = min(n_used[lane0 + l], S);
    // Phase 1: two-queue merge; a[t] becomes internal node t's weight,
    // later its parent's index + 1. The second pick reads the array after
    // the first pick's write.
    int leaf = 0, internal = 0;
    for (int t = 0; t < n - 1; ++t) {
      int w = 0;
      for (int k = 0; k < 2; ++k) {
        const int av_leaf = a[min(leaf, S - 1)][l];
        const int av_int = a[internal][l];
        if (leaf >= n || (internal < t && av_int < av_leaf)) {
          w += av_int;
          a[internal][l] = t + 1;
          ++internal;
        } else {
          w += av_leaf;
          ++leaf;
        }
      }
      a[t][l] = w;
    }
    // Phase 2: the root (written for every lane, n <= 1 included), then
    // depths down the parent chain; parents sit at larger indices.
    a[min(max(n - 2, 0), S - 1)][l] = 0;
    for (int t = min(S - 3, n - 3); t >= 0; --t) {
      a[t][l] = a[min(max(a[t][l] - 1, 0), S - 1)][l] + 1;
    }
  }
  __syncthreads();
  store_rows(out, a, tile, lane0, nl, S);
}

__global__ void kraft_kernel(const int32_t* __restrict__ lens_in,
                             const int32_t* __restrict__ n_used,
                             const int32_t* __restrict__ kraft0, int32_t* __restrict__ out,
                             int B, int S, int max_len) {
  __shared__ int32_t a[MAX_S][LANES];
  __shared__ int32_t tile[LANES][LANES + 1];
  const int lane0 = blockIdx.x * LANES;
  const int nl = min(LANES, B - lane0);
  const int l = threadIdx.x;
  load_rows(a, tile, lens_in, lane0, nl, S);
  if (l < nl) {
    const int n = min(n_used[lane0 + l], S);
    const int full = 1 << max_len;
    int kraft = kraft0[lane0 + l];
    // Phase A: lengthen the rarest (descending position) while the sum
    // is over; once it fits no later step changes anything.
    for (int p = n - 1; p >= 0 && kraft > full; --p) {
      const int len = a[p][l];
      if (len < max_len) {
        const int r = (full >> len) - (kraft - full);
        const int len_new = min(r <= 0 ? max_len : max(len, max_len - floor_log2(r)), max_len);
        kraft += (full >> len_new) - (full >> len);
        a[p][l] = len_new;
      }
    }
    // Phase B: re-shorten the most frequent (ascending position) while
    // room remains; the sum never decreases, so a full sum ends it.
    for (int p = 0; p < n && kraft < full; ++p) {
      const int len = a[p][l];
      const int u = full >> len;
      const int m = max(full - kraft, 0) / max(u, 1);
      const int d = min(floor_log2(m + 1), max(len - 1, 0));
      kraft += u * ((1 << d) - 1);
      a[p][l] = len - d;
    }
  }
  __syncthreads();
  store_rows(out, a, tile, lane0, nl, S);
}

}  // namespace

extern "C" int zt_mk12(const void* a0, const void* n_used, void* out, int B, int S,
                       void* stream) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    mk12_kernel<<<(B + LANES - 1) / LANES, LANES, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a0, (const int32_t*)n_used, (int32_t*)out, B, S);
  }
  return (int)cudaGetLastError();
}

extern "C" int zt_kraft(const void* lens, const void* n_used, const void* kraft0, void* out,
                        int B, int S, int max_len, void* stream) {
  if (S < 1 || S > MAX_S || max_len < 1 || max_len > 15) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    kraft_kernel<<<(B + LANES - 1) / LANES, LANES, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lens, (const int32_t*)n_used, (const int32_t*)kraft0, (int32_t*)out, B,
        S, max_len);
  }
  return (int)cudaGetLastError();
}
