// Match lengths of (pos, prev) pairs: for each pair, the number of equal
// leading bytes of data[pos:] and data[prev:], counted up to the pair's
// cap = min(n - pos, n - prev, 259) (0 when the cap is not positive or an
// index is negative), then clamped to 258 (MAX_MATCH_SIZE).
//
// Replaces the TPU kernel zultra_tpu/ops/matchlen.py::_matchlen_kernel
// (LZ77 match verification). None of its tiling survives: it loaded
// 128-aligned 640-byte rows and rotated them because a TPU lane slice must
// be aligned; here every byte is addressed directly.
//
// What bounds it on the card: the bytes moved. Each pair reads 8 bytes of
// indices and writes 4, and compares at most 2 x 259 data bytes, which
// come from L1/L2 when pairs are near each other (as an LZ parse's are).
//
// What this design does about it: one warp per pair. Lane k compares byte
// j*32 + k of the two spans in round j (read through the read-only path);
// __ballot_sync over "mismatch or past the cap" and __ffs give the first
// such byte, so a pair takes 1 to 9 rounds and stops at its first
// mismatch. Neighbouring lanes read neighbouring bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 pairs per block
constexpr int MAX_MATCH = 258;
constexpr int SPAN = MAX_MATCH + 1;

__global__ void matchlen_kernel(const uint8_t* __restrict__ data, long long n,
                                const int32_t* __restrict__ pos,
                                const int32_t* __restrict__ prev,
                                int32_t* __restrict__ out, long long n_pairs) {
  const long long pair = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;  // uniform across the warp
  const long long p = pos[pair];
  const long long q = prev[pair];
  long long cap = n - (p > q ? p : q);
  cap = cap < SPAN ? cap : SPAN;
  if (p < 0 || q < 0 || cap < 0) cap = 0;
  int length = (int)cap;
  for (int base = 0; base < cap; base += 32) {
    const long long k = base + lane;
    const bool stop = k >= cap || __ldg(data + p + k) != __ldg(data + q + k);
    const unsigned hit = __ballot_sync(0xffffffffu, stop);
    if (hit) {
      length = base + __ffs(hit) - 1;
      break;
    }
  }
  if (lane == 0) out[pair] = length < MAX_MATCH ? length : MAX_MATCH;
}

}  // namespace

extern "C" int zt_matchlen(const void* data, long long n, const void* pos, const void* prev,
                           void* out, long long n_pairs, void* stream) {
  if (n_pairs > 0) {
    const long long per_block = THREADS / 32;
    const long long blocks = (n_pairs + per_block - 1) / per_block;
    matchlen_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, n, (const int32_t*)pos, (const int32_t*)prev, (int32_t*)out,
        n_pairs);
  }
  return (int)cudaGetLastError();
}
