// Greedy token chain: marks every position of the hop chain
// p0 = start, p_{k+1} = p_k + max(step[p_k], 1), while p_k < length.
//
// Replaces the TPU kernel zultra_tpu/ops/chain_pallas.py::_chain_kernel
// (token boundaries of zultra src/blockdeflate.c:333-361), used by the
// block splitter and by every convergence pass of the block planner.
//
// What bounds it on the card: each hop's address depends on the value
// loaded by the previous hop, so one lane is a chain of dependent loads;
// read from global memory, each costs an L2 or HBM round trip.
//
// What this design does about it: one block per lane. The block's
// threads copy the lane's step values chunk by chunk into shared memory
// with coalesced loads, then one thread follows the hops inside the
// chunk at shared-memory latency and writes the marks (stores do not
// stall it). Hops never go backwards, so each chunk is loaded once.
// The marks tensor is zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 8192;  // 32 KB of step values per chunk

__global__ void chain_kernel(const int32_t* __restrict__ step_all,
                             const int32_t* __restrict__ start,
                             const int32_t* __restrict__ length,
                             int32_t* __restrict__ marks_all, int n) {
  __shared__ int32_t chunk[CHUNK];
  __shared__ int cur_s;
  const int lane = blockIdx.x;
  const int32_t* step = step_all + (size_t)lane * n;
  int32_t* marks = marks_all + (size_t)lane * n;
  const int end = min(length[lane], n);
  if (threadIdx.x == 0) cur_s = start[lane];
  __syncthreads();
  while (true) {
    const int cur0 = cur_s;
    if (cur0 >= end) break;
    const int base = cur0;
    const int lim = min(base + CHUNK, end);
    for (int i = threadIdx.x; i < lim - base; i += THREADS) chunk[i] = step[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int cur = cur0;
      while (cur < lim) {
        marks[cur] = 1;
        cur += max(chunk[cur - base], 1);
      }
      cur_s = cur;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int zt_chain(const void* step, const void* start, const void* length,
                        void* marks, int B, int n, void* stream) {
  if (B > 0 && n > 0) {
    chain_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)step, (const int32_t*)start, (const int32_t*)length,
        (int32_t*)marks, n);
  }
  return (int)cudaGetLastError();
}
