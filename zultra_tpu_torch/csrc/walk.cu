// Lazy LCP-interval walk: the match finder's sequential stage.
//
// Replaces the TPU kernel zultra_tpu/ops/walk_pallas.py::_walk_kernel
// (reference algorithm: zultra src/matchfinder.c:98-155 tree build,
// :171-234 lazy interval-ascent walk).
//
// One thread walks one segment buffer laid out as [HALO history | core |
// TAIL] (matchfinder_torch.build_segments). Phase 0 sweeps the rank-order
// SA|LCP words into the LCP-interval tree; phase 1 visits every position
// in order up to the end of the core and emits up to 8 packed
// (len << 16 | off) rows per core position into `rows`, which the caller
// zeroes.
//
// What bounds it on the card: the walk is a chain of dependent scalar
// loads and stores into tables of 2n+2 words per segment (about 0.5 MB
// at n = 65794), far more than the 227 KB of shared memory a block may
// have, so every access is a global-memory round trip served by L2 or
// HBM. Latency, not bandwidth or arithmetic, sets its speed.
//
// What this design does about it: each segment gets its own one-thread
// block, so the segments' dependent chains overlap across all SMs and
// no warp diverges; the tables live in a global scratch tensor (2n+2
// int32 per segment) and the 264-entry interval stack in local memory.
// Making one segment's chain faster is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LCP_SHIFT = 22;
constexpr uint32_t LCP_M = 511u << LCP_SHIFT;
constexpr uint32_t POS_M = (1u << LCP_SHIFT) - 1u;
constexpr uint32_t VIS = 0x80000000u;
constexpr uint32_t EXCL_VIS = 0x7FFFFFFFu;
constexpr int MAX_OFFSET = 32768;
constexpr int NMATCH = 8;
constexpr int STACK = 264;

__global__ void walk_kernel(const uint32_t* __restrict__ salcp_all,
                            uint32_t* __restrict__ tables, int32_t* __restrict__ rows_all,
                            int n, int halo, int core_len) {
  const int seg = blockIdx.x;
  const uint32_t* salcp = salcp_all + (size_t)seg * n;
  uint32_t* T = tables + (size_t)seg * (2 * (size_t)n + 2);  // intervals ++ pos_data
  uint32_t* P = T + n;
  int32_t* rows = rows_all + (size_t)seg * core_len * NMATCH;
  uint32_t stack[STACK];

  // ---- phase 0: interval tree from SA + LCP (stack sweep) ----
  int sp = 0;
  stack[0] = 0;
  T[0] = 0;
  uint32_t prev_pos = salcp[0] & POS_M;
  uint32_t nidx = 1;
  for (int i = 1; i < n; ++i) {
    const uint32_t packed = salcp[i];
    const uint32_t next_pos = packed & POS_M;
    const uint32_t next_lcp = packed & LCP_M;
    const uint32_t top = stack[sp];
    const uint32_t top_lcp = top & LCP_M;
    if (next_lcp == top_lcp) {
      P[prev_pos] = top;
    } else if (next_lcp > top_lcp) {
      const uint32_t ref = next_lcp | nidx++;
      stack[++sp] = ref;
      P[prev_pos] = ref;
    } else {
      P[prev_pos] = top;
      while (true) {
        const uint32_t closed = stack[sp] & POS_M;
        const int sp1 = sp - 1;
        const uint32_t s_lcp = stack[sp1] & LCP_M;
        int new_sp = sp1;
        if (next_lcp > s_lcp) {
          stack[sp1 + 1] = next_lcp | nidx++;
          new_sp = sp1 + 1;
        }
        T[closed] = stack[new_sp];
        sp = new_sp;
        if (next_lcp >= s_lcp) break;
      }
    }
    prev_pos = next_pos;
  }
  P[prev_pos] = stack[sp];
  while (sp > 0) {
    T[stack[sp] & POS_M] = stack[sp - 1];
    --sp;
  }

  // ---- phase 1: the lazy walk, position by position ----
  const int limit = halo + core_len;
  for (int p = 0; p < limit; ++p) {
    const int mm = p >= halo ? NMATCH : 0;
    uint32_t ref = P[p];
    P[p] = 0;
    uint32_t sref = T[ref & POS_M];
    // Ascend to the closest visited ancestor (or the root), marking
    // every interval on the way as visited by p.
    while (sref & LCP_M) {
      T[ref & POS_M] = (uint32_t)p | VIS;
      ref = sref;
      sref = T[sref & POS_M];
    }
    if (sref == 0) {
      if (ref != 0) T[ref & POS_M] = (uint32_t)p | VIS;
      continue;
    }
    uint32_t match_pos = sref & EXCL_VIS;
    int count = 0;
    while (true) {
      // Chase pos_data links to the nearest prior position parked no
      // deeper than ref.
      uint32_t s2 = P[match_pos];
      while (s2 > ref) {
        match_pos = T[s2 & POS_M] & EXCL_VIS;
        s2 = P[match_pos];
      }
      T[ref & POS_M] = (uint32_t)p | VIS;
      P[match_pos] = ref;
      const int off = p - (int)match_pos;
      if (count < mm && off <= MAX_OFFSET) {
        rows[(size_t)(p - halo) * NMATCH + count] = (int32_t)(((ref >> LCP_SHIFT) << 16) | (uint32_t)off);
        ++count;
      }
      if (s2 == 0) break;
      ref = s2;
      match_pos = T[ref & POS_M] & EXCL_VIS;
    }
  }
}

}  // namespace

extern "C" int zt_walk(const void* salcp, void* tables, void* rows, int S, int n,
                       int halo, int core_len, void* stream) {
  if (S > 0) {
    walk_kernel<<<S, 1, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)salcp, (uint32_t*)tables, (int32_t*)rows, n, halo, core_len);
  }
  return (int)cudaGetLastError();
}
