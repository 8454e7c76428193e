// The block splitter's prefix tables over each lane's compacted greedy
// tokens: P18 (W, n + 1, 18), the inclusive 18-bucket counts with a
// leading zero row (P18[w, t + 1, k] = tokens <= t of bucket k), and P256
// (W, n_q, 320), n_q = n / 256 + 2, the symbol counts of the tokens below
// each stride of 256 (P256[w, q] = sym1 and sym2 counts over tokens
// [0, 256 q)). Tokens at or past n_tok[w] count nowhere; a bucket outside
// 0..17 or a symbol outside 0..319 is dropped, as the plain form's drop
// bin does.
//
// No Pallas counterpart: it replaces the jnp.cumsum construction inside
// the jitted splitter (zultra_tpu/ops/split_jax.py:176-193). Caller:
// ops/prefix_cuda.py, from split_torch.split_batch (one call a splitter
// pass).
//
// What bounds it on the card: the bytes. At the splitter's W = 4, n = 2^21
// P18 alone is 604 MB written; the tokens' three int32 rows add 100 MB
// read and P256 42 MB written.
//
// What the design does about it: two launches, chunked by strides.
// - count: one block per (lane, chunk of `spc` strides; the caller passes
//   128) builds each stride's 321-bin histogram in shared memory and
//   writes it as P256's row (not yet a prefix), and writes the chunk's 18
//   bucket counts and 320 symbol counts to a scratch row.
// - write: one block per (lane, chunk) sums the scratch rows of the
//   chunks before its own (its offsets), then scans its strides' rows of
//   P256 in place, a thread a bin; and each warp takes 32 * spc tokens
//   of the chunk, counts their buckets (18 ballots per 32 tokens), adds
//   the counts of the warps before it, and walks its tokens in order, lane
//   k carrying bucket k's count and writing it to each row: every row of
//   P18 is 72 contiguous bytes from one store instruction, and nothing
//   is read back. No one-hot is built and the table is written once.
// ops/prefix_cuda.py holds the plain model of this schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STRIDE = 256;  // tokens a row of P256 advances
constexpr int NB = 18;       // drift buckets
constexpr int NBINS = 320;   // literal/length + offset symbols
constexpr int COLS = NB + NBINS;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS)
    prefix_tables_count_kernel(const int32_t* __restrict__ bucket,
                               const int32_t* __restrict__ sym1,
                               const int32_t* __restrict__ sym2,
                               const int32_t* __restrict__ n_tok, int32_t* __restrict__ p256,
                               int32_t* __restrict__ scratch, int n, int n_q, int spc, int nc) {
  __shared__ int hist[NBINS + 1];
  __shared__ int c18[NB];
  const int w = blockIdx.y, j = blockIdx.x, tid = threadIdx.x;
  const int nt = max(min(n_tok[w], n), 0);
  const int n_strides = n_q - 1;
  const size_t lane_off = (size_t)w * n;
  if (tid < NB) c18[tid] = 0;
  int tot0 = 0, tot1 = 0;  // this thread's bins tid and tid + THREADS over the chunk
  for (int s = 0; s < spc; ++s) {
    const int q = j * spc + s;
    if (q >= n_strides) break;  // uniform over the block
    for (int b = tid; b <= NBINS; b += THREADS) hist[b] = 0;
    __syncthreads();
    const int t = q * STRIDE + tid;
    if (t < nt) {
      const int s1 = sym1[lane_off + t], s2 = sym2[lane_off + t], bk = bucket[lane_off + t];
      atomicAdd(&hist[(unsigned)s1 < (unsigned)NBINS ? s1 : NBINS], 1);
      atomicAdd(&hist[(unsigned)s2 < (unsigned)NBINS ? s2 : NBINS], 1);
      if ((unsigned)bk < (unsigned)NB) atomicAdd(&c18[bk], 1);
    }
    __syncthreads();
    int32_t* row = p256 + ((size_t)w * n_q + q + 1) * NBINS;
    row[tid] = hist[tid];
    tot0 += hist[tid];
    if (tid + THREADS < NBINS) {
      row[tid + THREADS] = hist[tid + THREADS];
      tot1 += hist[tid + THREADS];
    }
    __syncthreads();  // before the next stride zeroes the bins
  }
  int32_t* sc = scratch + ((size_t)w * nc + j) * COLS;
  if (tid < NB) sc[tid] = c18[tid];
  sc[NB + tid] = tot0;
  if (tid + THREADS < NBINS) sc[NB + tid + THREADS] = tot1;
}

__global__ void __launch_bounds__(THREADS)
    prefix_tables_write_kernel(const int32_t* __restrict__ bucket,
                               const int32_t* __restrict__ n_tok, int32_t* __restrict__ p18,
                               int32_t* __restrict__ p256, const int32_t* __restrict__ scratch,
                               int n, int n_q, int spc, int nc) {
  __shared__ int base18[NB];
  __shared__ int warp18[WARPS][NB];
  const int w = blockIdx.y, j = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nt = max(min(n_tok[w], n), 0);
  const int n_strides = n_q - 1;

  // Offsets: the counts of every chunk before this one. Thread tid holds
  // scratch columns tid and tid + THREADS (18 buckets, then 320 bins).
  const int32_t* sc = scratch + (size_t)w * nc * COLS;
  const bool has_hi = tid + THREADS < COLS;
  int acc0 = 0, acc1 = 0;
  for (int jj = 0; jj < j; ++jj) {
    acc0 += sc[(size_t)jj * COLS + tid];
    if (has_hi) acc1 += sc[(size_t)jj * COLS + tid + THREADS];
  }
  if (tid < NB) base18[tid] = acc0;

  // P256: rows 1..n_q - 1 hold each stride's histogram; scan this chunk's
  // rows in place from the offset (row 0 is all zeros).
  int32_t* p = p256 + (size_t)w * n_q * NBINS;
  if (j == 0) {
    for (int b = tid; b < NBINS; b += THREADS) p[b] = 0;
  }
  const int bin0 = tid - NB, bin1 = tid + THREADS - NB;  // the bins of acc0 and acc1
  for (int s = 0; s < spc; ++s) {
    const int q = j * spc + s;
    if (q >= n_strides) break;
    int32_t* row = p + (size_t)(q + 1) * NBINS;
    if (bin0 >= 0) {
      acc0 += row[bin0];
      row[bin0] = acc0;
    }
    if (has_hi) {
      acc1 += row[bin1];
      row[bin1] = acc1;
    }
  }

  // P18: each warp's tokens [t0, t1) of the chunk.
  const int per_warp = 32 * spc;
  const int t0 = j * spc * STRIDE + warp * per_warp;
  const int t1 = min(t0 + per_warp, n);
  const int tv = min(t1, nt);  // tokens below tv count
  int cnt = 0;                 // lane k < 18: bucket k over the warp's tokens
  for (int t = t0; t < tv; t += 32) {
    const int b = t + lane < tv ? bucket[(size_t)w * n + t + lane] : -1;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int c = __popc(__ballot_sync(FULL, b == k));
      if (lane == k) cnt += c;
    }
  }
  if (lane < NB) warp18[warp][lane] = cnt;
  __syncthreads();
  int run = 0;
  if (lane < NB) {
    run = base18[lane];
    for (int ww = 0; ww < warp; ++ww) run += warp18[ww][lane];
  }
  int32_t* out = p18 + (size_t)w * (n + 1) * NB;
  if (j == 0 && warp == 0 && lane < NB) out[lane] = 0;
  for (int t = t0; t < t1; t += 32) {
    const int b = t + lane < tv ? bucket[(size_t)w * n + t + lane] : -1;
    int32_t* rows = out + (size_t)(t + 1) * NB + lane;
    if (t + 32 <= t1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        run += __shfl_sync(FULL, b, i) == lane;
        if (lane < NB) rows[i * NB] = run;
      }
    } else {
      for (int i = 0; i < t1 - t; ++i) {
        run += __shfl_sync(FULL, b, i) == lane;
        if (lane < NB) rows[i * NB] = run;
      }
    }
  }
}

}  // namespace

extern "C" int zt_prefix_tables(const void* bucket, const void* sym1, const void* sym2,
                                const void* n_tok, void* p18, void* p256, void* scratch, int W,
                                int n, int spc, void* stream) {
  if (W < 0 || n < 1 || spc < 1) return (int)cudaErrorInvalidValue;
  const int n_q = n / STRIDE + 2;
  const int nc = (n_q - 1 + spc - 1) / spc;
  if (W > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(nc, W);
    prefix_tables_count_kernel<<<grid, THREADS, 0, st>>>(
        (const int32_t*)bucket, (const int32_t*)sym1, (const int32_t*)sym2,
        (const int32_t*)n_tok, (int32_t*)p256, (int32_t*)scratch, n, n_q, spc, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    prefix_tables_write_kernel<<<grid, THREADS, 0, st>>>(
        (const int32_t*)bucket, (const int32_t*)n_tok, (int32_t*)p18, (int32_t*)p256,
        (const int32_t*)scratch, n, n_q, spc, nc);
  }
  return (int)cudaGetLastError();
}
