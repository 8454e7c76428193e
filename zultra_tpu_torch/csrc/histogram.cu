// Byte histogram: counts[v] += 1 for every byte v of data (256 bins; the
// wrapper keeps the bins below n_symbols).
//
// Replaces the TPU kernel zultra_tpu/ops/histogram.py::_hist_kernel, which
// summed one-hot tiles on the matrix unit in float32 and so had to cut
// inputs at 2^24 bytes to stay exact. Integer counters need no such cut:
// the count is exact for any n.
//
// What bounds it on the card: the bytes read (n), with a 2 KB result. The
// risk is contention: text repeats a few byte values, and atomics on one
// address serialise.
//
// What this design does about it: each warp of a block keeps its own
// 256-bin histogram of 32-bit counters in shared memory, so only the 32
// lanes of one warp can collide on a bin. Each thread reads 16 bytes at a
// time (uint4) over a grid-stride range of the 16-byte-aligned body; block
// 0 also takes the unaligned head and the tail byte by byte. At the end
// each block adds its 256 sums into the int64 result with one atomicAdd on
// unsigned long long per non-zero bin. The caller zeroes the result and
// sizes the grid so that no block counts 2^32 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void count_word(uint32_t* h, uint32_t w) {
  atomicAdd(h + (w & 0xff), 1u);
  atomicAdd(h + ((w >> 8) & 0xff), 1u);
  atomicAdd(h + ((w >> 16) & 0xff), 1u);
  atomicAdd(h + (w >> 24), 1u);
}

__global__ void hist_kernel(const uint8_t* __restrict__ data, long long n, long long head,
                            long long n_vec, unsigned long long* __restrict__ counts) {
  __shared__ uint32_t hist[WARPS][256];
  for (int i = threadIdx.x; i < WARPS * 256; i += THREADS) (&hist[0][0])[i] = 0;
  __syncthreads();
  uint32_t* h = hist[threadIdx.x / 32];

  const uint4* body = reinterpret_cast<const uint4*>(data + head);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n_vec; i += stride) {
    const uint4 v = __ldg(body + i);
    count_word(h, v.x);
    count_word(h, v.y);
    count_word(h, v.z);
    count_word(h, v.w);
  }
  if (blockIdx.x == 0) {
    for (long long i = threadIdx.x; i < head; i += THREADS) atomicAdd(h + data[i], 1u);
    for (long long i = head + n_vec * 16 + threadIdx.x; i < n; i += THREADS)
      atomicAdd(h + data[i], 1u);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < 256; b += THREADS) {
    unsigned long long sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += hist[w][b];
    if (sum) atomicAdd(counts + b, sum);
  }
}

}  // namespace

extern "C" int zt_hist(const void* data, long long n, void* counts, int blocks, void* stream) {
  if (n > 0 && blocks > 0) {
    const uintptr_t addr = (uintptr_t)data;
    long long head = (long long)((16 - (addr & 15)) & 15);
    if (head > n) head = n;
    const long long n_vec = (n - head) / 16;
    hist_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, n, head, n_vec, (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}
