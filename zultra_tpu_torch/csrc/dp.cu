// Backward optimal-parse cost DP over a batch of block lanes.
//
// Replaces the TPU kernel zultra_tpu/ops/dp_pallas.py::_dp_kernel
// (reference semantics: zultra src/blockdeflate.c:254-323). At each
// position p, from the block end down to 0:
//   literal   lit[p] + cost[p+1]
//   shorts    per slot, the cheapest truncation k = 3..sc of a match
//             shorter than 40: one packed (min(varlen_k + cost[p+k],
//             CLAMPX) << 6 | 63-k) prefix minimum, so the largest k wins
//             ties, plus the slot's offset bits
//   longs     per slot, lcs + cost[p+clamped] (0 past the block end)
//   winner    the packed minimum of (cost*16 | candidate), candidates in
//             the reference's order: literal, then slots 0..7
// and writes chosen_len | slot << 9. The constants and packings are the
// TPU kernel's (dp_pallas.py:60-65, 105-150), so the choices agree bit
// for bit. cost[p] = 0 for p >= n is the boundary condition.
//
// What bounds it on the card: cost[p] depends on cost[p+1..p+258], so a
// lane is one long sequential recurrence of a few hundred integer
// operations per position; the inputs stream once (68 bytes a position).
//
// What this design does about it: one block per lane. The cost ring
// (512 entries, the last 259 costs) lives in shared memory. The block's
// threads stage the lane's inputs chunk by chunk (256 positions) into
// shared memory with coalesced loads; one thread then runs the chunk's
// recurrence from shared memory alone. Spreading a position's 37
// truncations over a warp is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 26;
constexpr int INF16 = 0x7FFF;
constexpr int CLAMPX = (1 << 24) - 1;
constexpr int MIN_MATCH = 3;
constexpr int LEAVE_ALONE = 40;
constexpr int NM = 8;
constexpr int THREADS = 128;
constexpr int CHUNK = 256;
constexpr int RING = 512;  // power of two > 259 (deepest tap is p + 258)

__global__ void dp_kernel(const int32_t* __restrict__ lit_all, const int32_t* __restrict__ p1_all,
                          const int32_t* __restrict__ p2_all, const int32_t* __restrict__ varlen40,
                          int32_t* __restrict__ out_all, int n) {
  __shared__ int32_t s_lit[CHUNK];
  __shared__ int32_t s_p1[CHUNK * NM];
  __shared__ int32_t s_p2[CHUNK * NM];
  __shared__ int32_t ring[RING];
  __shared__ int32_t vl[LEAVE_ALONE - MIN_MATCH];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* lit = lit_all + (size_t)lane * n;
  const int32_t* p1 = p1_all + (size_t)lane * n * NM;
  const int32_t* p2 = p2_all + (size_t)lane * n * NM;
  int32_t* out = out_all + (size_t)lane * n;

  for (int i = tid; i < RING; i += THREADS) ring[i] = 0;
  for (int i = tid; i < LEAVE_ALONE - MIN_MATCH; i += THREADS) vl[i] = varlen40[lane * 40 + i];

  for (int c0 = ((n - 1) / CHUNK) * CHUNK; c0 >= 0; c0 -= CHUNK) {
    const int len = min(CHUNK, n - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < len; i += THREADS) s_lit[i] = lit[c0 + i];
    for (int i = tid; i < len * NM; i += THREADS) {
      s_p1[i] = p1[(size_t)c0 * NM + i];
      s_p2[i] = p2[(size_t)c0 * NM + i];
    }
    __syncthreads();
    if (tid != 0) continue;

    int pm[LEAVE_ALONE - MIN_MATCH];
    for (int j = len - 1; j >= 0; --j) {
      const int p = c0 + j;
      // Shorts: packed prefix minimum over k = 3..39.
      int run = 0x7FFFFFFF;
#pragma unroll
      for (int k = MIN_MATCH; k < LEAVE_ALONE; ++k) {
        const int x = min(vl[k - MIN_MATCH] + ring[(p + k) & (RING - 1)], CLAMPX);
        run = min(run, x * 64 + (63 - k));
        pm[k - MIN_MATCH] = run;
      }
      int key = (s_lit[j] + ring[(p + 1) & (RING - 1)]) * 16;
      int lsel = 0;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int a = s_p1[j * NM + m];
        const int sc = a >> 16;
        const int osz = a & 0xFFFF;
        const int wg = pm[max(sc - MIN_MATCH, 0)];
        const int cand_s = sc >= MIN_MATCH ? (wg >> 6) + osz : INF;
        const int b = s_p2[j * NM + m];
        const int cl = b >> 16;
        const int lcs = b & 0xFFFF;
        const bool valid_l = lcs != INF16;
        const int fut = cl < LEAVE_ALONE ? 0 : ring[(p + cl) & (RING - 1)];
        const int cand_l = valid_l ? lcs + fut : INF;
        const int cand = min(cand_s, cand_l);
        const int km = cand * 16 + m + 1;
        if (km < key) {
          key = km;
          lsel = valid_l ? cl : 63 - (wg & 63);
        }
      }
      const int mcode = key & 15;
      ring[p & (RING - 1)] = key >> 4;
      out[p] = (mcode > 0 ? lsel : 0) | (mcode << 9);
    }
  }
}

}  // namespace

extern "C" int zt_dp(const void* lit, const void* p1, const void* p2, const void* varlen40,
                     void* out, int B, int n, void* stream) {
  if (B > 0 && n > 0) {
    dp_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lit, (const int32_t*)p1, (const int32_t*)p2,
        (const int32_t*)varlen40, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
