// Byte histogram: out[v] = the count of bytes v in data, as int64, for
// v < n_symbols (bins from 256 up to n_symbols are 0).
//
// Replaces the TPU kernel zultra_tpu/ops/histogram.py::_hist_kernel, which
// summed one-hot tiles on the matrix unit in float32 and so had to cut
// inputs at 2^24 bytes to stay exact. Integer counters need no such cut:
// the count is exact for any n.
//
// What bounds it on the card: the bytes read (n), with a 2 KB result; and,
// behind them, the shared-memory atomics that count them (one a byte).
//
// What this design does about it: one launch writes the answer; nothing
// is zeroed or copied around it.
//   Count: the grid is sized from the card (the wrapper passes at most SMs
//   x resident blocks, fewer for a small input). The 16-byte-aligned body
//   is cut into steps of THREADS x UNROLL words; block b takes steps b,
//   b + grid, ... and each thread issues its UNROLL independent 16-byte
//   loads before it counts any, so a resident grid keeps megabytes in
//   flight. Each warp counts into its own 256 32-bit counters in shared
//   memory. A word of 16 equal bytes is a run: a thread keeps its last
//   run's byte and count in registers and adds them once the byte
//   changes. (Merging a warp's equal bytes with __match_any_sync first
//   was 3x slower on an H100 on the text corpus, 16x on random bytes.)
//   Block 0 also counts the unaligned head and the tail, byte by byte.
//   Finish: each block adds its non-zero sums (32-bit: the wrapper keeps
//   a block's bytes below 2^32) into 256 64-bit accumulators with
//   fire-and-forget atomics, fences, and takes a ticket. The block that
//   takes the last ticket reads the accumulators, writes all n_symbols
//   bins of the result, and sets the accumulators and the ticket back to
//   0 for the next call. The wrapper keeps one such state a stream, made
//   zero once, so calls on one stream run in order. Integer sums: exact,
//   and the same on every run whatever the blocks' order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // one thread per bin when a block merges its warps
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
constexpr int UNROLL = 4;  // 16-byte loads each thread has in flight

// Count the 16 bytes of v. A run of 16 equal bytes goes to the thread's
// pending run instead.
__device__ __forceinline__ void count_word(uint32_t* h, uint4 v, uint32_t& run_byte,
                                           uint32_t& run_count) {
  const uint32_t byte = v.x & 0xffu;
  const uint32_t splat = byte * 0x01010101u;
  if (v.x == splat && v.y == splat && v.z == splat && v.w == splat) {
    if (run_count && byte != run_byte) atomicAdd(h + run_byte, run_count);
    run_count = byte == run_byte ? run_count + 16 : 16;
    run_byte = byte;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) atomicAdd(h + ((w[i] >> (8 * k)) & 0xffu), 1u);
  }
}

__global__ void __launch_bounds__(THREADS)
    hist_kernel(const uint8_t* __restrict__ data, long long n, long long head, long long n_vec,
                long long* __restrict__ out, int n_symbols, unsigned long long* state) {
  __shared__ uint32_t hist[WARPS][BINS];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) (&hist[0][0])[i] = 0;
  __syncthreads();
  uint32_t* h = hist[warp];

  const uint4* body = reinterpret_cast<const uint4*>(data + head);
  const long long step = (long long)THREADS * UNROLL;
  uint32_t run_byte = 0, run_count = 0;
  for (long long at = (long long)blockIdx.x * step; at < n_vec; at += (long long)gridDim.x * step) {
    uint4 v[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = at + u * THREADS + threadIdx.x;
      ok[u] = i < n_vec;
      v[u] = ok[u] ? __ldg(body + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) count_word(h, v[u], run_byte, run_count);
  }
  if (run_count) atomicAdd(h + run_byte, run_count);
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long tail = head + n_vec * 16;  // first byte after the body
    if (threadIdx.x < head) atomicAdd(h + data[threadIdx.x], 1u);
    if (tail + threadIdx.x < n) atomicAdd(h + data[tail + threadIdx.x], 1u);
  }
  __syncthreads();

  // Finish: merge into the accumulators, then the last block writes out.
  uint32_t sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) sum += hist[w][threadIdx.x];
  if (sum) atomicAdd(state + threadIdx.x, (unsigned long long)sum);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(state + BINS, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned long long total = __ldcg(state + threadIdx.x);
  state[threadIdx.x] = 0;
  if (threadIdx.x == 0) state[BINS] = 0;
  for (int bin = threadIdx.x; bin < n_symbols; bin += THREADS)
    out[bin] = bin < BINS ? (long long)total : 0;
}

}  // namespace

// Blocks of hist_kernel that one SM holds at once.
extern "C" int zt_hist_blocks_per_sm() {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel, THREADS, 0);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// head: the bytes before data's first 16-byte-aligned address (at most
// n); n_vec: the whole 16-byte words after them. state: 257 uint64 (the
// accumulators and the ticket), zero before the call and left zero by it.
extern "C" int zt_hist(const void* data, long long n, long long head, long long n_vec,
                       void* out, int n_symbols, void* state, int blocks, void* stream) {
  if (blocks < 1 || n_symbols < 1) return (int)cudaErrorInvalidValue;
  hist_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, n, head, n_vec, (long long*)out, n_symbols,
      (unsigned long long*)state);
  return (int)cudaGetLastError();
}
