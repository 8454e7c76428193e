// Match lengths of (pos, prev) pairs: for each pair, the number of equal
// leading bytes of data[pos:] and data[prev:], counted up to the pair's
// cap = min(n - pos, n - prev, 259) (0 when the cap is not positive or an
// index is negative), then clamped to 258 (MAX_MATCH_SIZE).
//
// Replaces the TPU kernel zultra_tpu/ops/matchlen.py::_matchlen_kernel
// (LZ77 match verification). None of its tiling survives: it loaded
// 128-aligned 640-byte rows and rotated them because a TPU lane slice must
// be aligned; here each thread reads the aligned words around its pair.
//
// What bounds it on the card: latency, not bytes. A pair's indices (8
// bytes) and its result (4) are the only device-memory traffic that must
// move; the data comes from L1/L2. Each pair is a short chain of
// dependent loads: its indices, then its data, then, for a long match,
// more data.
//
// What this design does about it: a thread per pair for the first K = 16
// bytes (the head), a warp per pair for the rest (the tail).
//   Head: a warp takes 32 consecutive pairs (coalesced index loads and
//   stores). Each thread issues every aligned 16-byte word that the
//   spans [p, p + K) and [q, q + K) touch before it compares any,
//   so the head is one round of loads; it aligns them with a word shift
//   and __funnelshift_r, XORs them and takes the first differing byte with
//   __ffs. A pair that differs, or reaches its cap, within K bytes is done.
//   Tail: a pair still equal after K bytes and below its cap takes a slot
//   in the block's queue in shared memory (one __ballot_sync, __popc and
//   one shared atomic per warp). After a barrier each warp finishes queued
//   pairs one at a time: lane j compares bytes [K + 8j, K + 8j + 8) of the
//   pair, read as the one or two aligned 8-byte words that hold them a
//   side, so one round covers the whole span up to 259; __ballot_sync and
//   __ffs give the first lane with a stop and __shfl_sync its byte.
//
// No load leaves the aligned 16-byte word that holds data[n - 1] (words at
// or past `lim` are not loaded; the cap masks the bytes they would hold),
// and a load before data[0] stays in data[0]'s own aligned word. The data
// pointer may have any alignment. Indices are 64-bit inside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // pairs per block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_MATCH = 258;
constexpr int SPAN = MAX_MATCH + 1;
constexpr unsigned FULL = 0xffffffffu;
// Bytes each thread compares before a pair goes to the warp tail: on the
// match pairs of an LZ corpus, 91.5 % end within 16 bytes (PERF.md §6).
constexpr int K = 16;

// Bytes [a, a + K) as K / 4 little-endian 32-bit words. The K-byte span
// touches at most two aligned 16-byte words; both are loaded first (a
// word at or past lim reads as 0), then shifted down by a's offset in its
// word: whole 32-bit words by a log shifter on static indices (so the
// array stays in registers), the rest by a funnel shift.
__device__ __forceinline__ void load_head(const uint8_t* a, uintptr_t lim, uint32_t (&out)[K / 4]) {
  constexpr int LOADS = K / 16 + 1;
  constexpr int NW = LOADS * 4;
  const uintptr_t addr = (uintptr_t)a;
  const uintptr_t base = addr & ~(uintptr_t)15;
  uint32_t r[NW];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const uintptr_t at = base + (uintptr_t)i * 16;
    const uint4 v = at < lim ? __ldg((const uint4*)at) : make_uint4(0, 0, 0, 0);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
  const int s = (int)(addr & 15);
#pragma unroll
  for (int bit = 1; bit < 4; bit <<= 1) {
    if ((s >> 2) & bit) {
#pragma unroll
      for (int i = 0; i + bit < NW; ++i) r[i] = r[i + bit];
    }
  }
  const int sh = (s & 3) * 8;
#pragma unroll
  for (int i = 0; i < K / 4; ++i) out[i] = __funnelshift_r(r[i], r[i + 1], sh);
}

// Eight bytes at a (a <= data + n - 1, so its aligned word lies below
// lim), from the one or two aligned 8-byte words that hold them.
__device__ __forceinline__ unsigned long long load8(const uint8_t* a, uintptr_t lim) {
  const uintptr_t addr = (uintptr_t)a;
  const uintptr_t base = addr & ~(uintptr_t)7;
  const int sh = (int)(addr & 7) * 8;
  const unsigned long long lo = __ldg((const unsigned long long*)base);
  const unsigned long long hi =
      sh && base + 8 < lim ? __ldg((const unsigned long long*)(base + 8)) : 0ull;
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

__global__ void __launch_bounds__(THREADS)
    matchlen_kernel(const uint8_t* __restrict__ data, long long n, uintptr_t lim,
                    const int32_t* __restrict__ pos, const int32_t* __restrict__ prev,
                    int32_t* __restrict__ out, long long n_pairs) {
  __shared__ int q_pos[THREADS];
  __shared__ int q_prev[THREADS];
  __shared__ int q_meta[THREADS];  // (pair within the block) << 16 | cap
  __shared__ int q_len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * THREADS;
  const long long pair = first + threadIdx.x;
  if (threadIdx.x == 0) q_len = 0;

  // -- head: a thread per pair ------------------------------------------
  long long p = 0, q = 0, cap = 0;
  if (pair < n_pairs) {
    p = pos[pair];
    q = prev[pair];
    cap = n - (p > q ? p : q);
    cap = cap < SPAN ? cap : SPAN;
    if (p < 0 || q < 0 || cap < 0) cap = 0;
  }
  int len = 0;
  if (cap > 0) {
    uint32_t a[K / 4], b[K / 4];
    load_head(data + p, lim, a);
    load_head(data + q, lim, b);
    len = K;
#pragma unroll
    for (int i = K / 4 - 1; i >= 0; --i) {
      const uint32_t d = a[i] ^ b[i];
      if (d) len = 4 * i + ((__ffs(d) - 1) >> 3);
    }
    if (len > cap) len = (int)cap;
  }
  const bool more = len == K && cap > K;
  __syncthreads();  // q_len is 0
  const unsigned queued = __ballot_sync(FULL, more);
  if (queued) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&q_len, __popc(queued));
    base = __shfl_sync(FULL, base, 0);
    if (more) {
      const int slot = base + __popc(queued & ((1u << lane) - 1));
      q_pos[slot] = (int)p;
      q_prev[slot] = (int)q;
      q_meta[slot] = (int)(threadIdx.x << 16) | (int)cap;
    }
  }
  if (!more && pair < n_pairs) out[pair] = len;  // len <= K < MAX_MATCH
  __syncthreads();

  // -- tail: a warp per queued pair -------------------------------------
  const int total = q_len;
  for (int e = warp; e < total; e += WARPS) {
    const long long tp = q_pos[e];
    const long long tq = q_prev[e];
    const int meta = q_meta[e];
    const int tcap = meta & 0xffff;
    const int k0 = K + 8 * lane;
    unsigned long long d = 1ull;  // past the cap: a stop at this lane's byte 0
    if (k0 < tcap) {
      d = load8(data + tp + k0, lim) ^ load8(data + tq + k0, lim);
      const int rem = tcap - k0;
      if (rem < 8) d |= 1ull << (8 * rem);
    }
    const int at = d ? (__ffsll((long long)d) - 1) >> 3 : 8;
    const unsigned hit = __ballot_sync(FULL, at < 8);  // never 0: K + 8 * 32 > SPAN
    const int src = __ffs(hit) - 1;
    const int length = K + 8 * src + __shfl_sync(FULL, at, src);
    if (lane == 0) out[first + (meta >> 16)] = length < MAX_MATCH ? length : MAX_MATCH;
  }
}

}  // namespace

extern "C" int zt_matchlen(const void* data, long long n, const void* pos, const void* prev,
                           void* out, long long n_pairs, void* stream) {
  if (n_pairs <= 0) return (int)cudaGetLastError();
  const auto* d = (const uint8_t*)data;
  // The first address past the aligned 16-byte word that holds data[n-1].
  const uintptr_t lim = n > 0 ? (((uintptr_t)(d + n - 1)) & ~(uintptr_t)15) + 16 : 0;
  const long long blocks = (n_pairs + THREADS - 1) / THREADS;
  matchlen_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      d, n, lim, (const int32_t*)pos, (const int32_t*)prev, (int32_t*)out, n_pairs);
  return (int)cudaGetLastError();
}
