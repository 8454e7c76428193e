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
// What bounds it on the card: the bytes written. At the splitter's W = 4,
// n = 2^21 P18 alone is 604 MB and P256 42 MB; the tokens below n_tok add
// about 10 MB read on the 4 MiB gzip run.
//
// What the design does about it: tiles of TILE rows of P18 in the table's
// flat row index w (n + 1) + t + 1, aligned to TILE there (a lane's first
// and last tile cut at its ends), thousands of blocks a call; 16 rows are
// 1152 bytes, nine whole 128-byte lines, so every group of 32 rows that
// lies inside a tile is 18 whole lines. Three launches:
// - count: a tile's bucket counts (18 ballots per 32 tokens) and symbol
//   counts (shared adds) of its tokens below n_tok, to a scratch row;
// - scan: an exclusive sum over a lane's tiles of each of the 338 scratch
//   columns in place (tiles past n_tok are not read), and the lane's
//   totals to the row after its last tile;
// - write: a tile takes its offsets from its scratch row (a tile past
//   n_tok the totals). Its symbols go by stride into shared bins and its
//   rows of P256 are their running sums from the offset (a row a stride
//   that ends in the tile). Its 8 warps take 256 rows of P18 each: the
//   warps' bucket counts first (18 ballots per 32 tokens, from registers),
//   then each lane's row in parallel, base_k + popc(ballot(bucket == k) &
//   lanemask_le), staged as 32 rows in shared memory and stored as 16-byte
//   vectors over whole lines, streaming (P18 is 12 times the L2); a run of
//   rows with no token below n_tok stages the constant row once. Only a
//   lane's head and tail groups store row by row.
// ops/prefix_cuda.py holds the plain model of this schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;                    // rows of P18 a tile (prefix_cuda.TILE)
constexpr int GROUPS = TILE / 32 / WARPS;     // groups of 32 rows a warp
constexpr int STRIDE = 256;                   // tokens a row of P256 advances
constexpr int MAX_ROWS = TILE / STRIDE + 2;   // rows of P256 a tile writes
constexpr int NB = 18;                        // drift buckets
constexpr int NBINS = 320;                    // literal/length + offset symbols
constexpr int COLS = NB + NBINS;
constexpr int SCAN_THREADS = 1024;            // 32 columns x 32 runs of tiles
constexpr unsigned FULL = 0xFFFFFFFFu;

// Tile x of lane w: flat rows [r0, r1) (empty when r0 >= r1), tokens
// [a, b) = [r0 - L0 - 1, r1 - L0 - 1), a >= -1 (row L0 is the zero row).
struct Tile {
  long long frame, r0, r1;  // frame: the TILE-aligned row the tile's warps count from
  int a, b;
};

__device__ __forceinline__ Tile tile_of(int w, int x, int n) {
  const long long L0 = (long long)w * (n + 1);
  const long long frame = (L0 / TILE + x) * TILE;
  Tile t;
  t.frame = frame;
  t.r0 = max(L0, frame);
  t.r1 = min(L0 + n + 1, frame + TILE);
  t.a = (int)(t.r0 - L0 - 1);
  t.b = (int)(t.r1 - L0 - 1);
  return t;
}

// Tiles 0..valid_tiles - 1 of lane w hold a token below nt.
__device__ __forceinline__ int valid_tiles(int w, int n, int nt) {
  const long long L0 = (long long)w * (n + 1);
  return nt > 0 ? (int)((L0 + nt) / TILE - L0 / TILE + 1) : 0;
}

__device__ __forceinline__ int lane_n_tok(const int32_t* n_tok, int w, int n) {
  return max(min(n_tok[w], n), 0);
}

__global__ void __launch_bounds__(THREADS)
    prefix_tables_count_kernel(const int32_t* __restrict__ bucket,
                               const int32_t* __restrict__ sym1,
                               const int32_t* __restrict__ sym2,
                               const int32_t* __restrict__ n_tok, int32_t* __restrict__ scratch,
                               int n, int NX) {
  __shared__ int c_s[COLS];
  const int w = blockIdx.y, x = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
  const int nt = lane_n_tok(n_tok, w, n);
  if (x >= valid_tiles(w, n, nt)) return;  // the whole block
  const Tile tl = tile_of(w, x, n);
  const int lo = max(tl.a, 0), hi = min(tl.b, nt);  // tokens that count
  for (int c = tid; c < COLS; c += THREADS) c_s[c] = 0;
  const size_t off = (size_t)w * n;
  int bk[TILE / THREADS], s1[TILE / THREADS], s2[TILE / THREADS];
#pragma unroll
  for (int i = 0; i < TILE / THREADS; ++i) {
    const int t = lo + tid + i * THREADS;
    const bool in = t < hi;
    bk[i] = in ? bucket[off + t] : -1;
    s1[i] = in ? sym1[off + t] : NBINS;
    s2[i] = in ? sym2[off + t] : NBINS;
  }
  __syncthreads();
  int cnt = 0;  // lane k < 18: bucket k over the warp's tokens
#pragma unroll
  for (int i = 0; i < TILE / THREADS; ++i) {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int c = __popc(__ballot_sync(FULL, bk[i] == k));
      if (lane == k) cnt += c;
    }
    if ((unsigned)s1[i] < (unsigned)NBINS) atomicAdd(&c_s[NB + s1[i]], 1);
    if ((unsigned)s2[i] < (unsigned)NBINS) atomicAdd(&c_s[NB + s2[i]], 1);
  }
  if (lane < NB && cnt) atomicAdd(&c_s[lane], cnt);
  __syncthreads();
  int32_t* row = scratch + ((size_t)w * (NX + 1) + x) * COLS;
  for (int c = tid; c < COLS; c += THREADS) row[c] = c_s[c];
}

__global__ void __launch_bounds__(SCAN_THREADS)
    prefix_tables_scan_kernel(const int32_t* __restrict__ n_tok, int32_t* __restrict__ scratch,
                              int n, int NX) {
  __shared__ int part_s[32][33];
  const int w = blockIdx.y, tid = threadIdx.x;
  const int c = tid % 32, s = tid / 32;
  const int col = blockIdx.x * 32 + c;
  const int v = valid_tiles(w, n, lane_n_tok(n_tok, w, n));
  const int per = (v + 31) / 32;
  const int lo = min(s * per, v), hi = min(lo + per, v);
  int32_t* p = scratch + (size_t)w * (NX + 1) * COLS + col;
  int sum = 0;
  if (col < COLS) {
    for (int x = lo; x < hi; ++x) sum += p[(size_t)x * COLS];
  }
  part_s[s][c] = sum;
  __syncthreads();
  if (s == 0) {
    int run = 0;
    for (int j = 0; j < 32; ++j) {
      const int t = part_s[j][c];
      part_s[j][c] = run;
      run += t;
    }
    if (col < COLS) p[(size_t)NX * COLS] = run;  // the lane's totals
  }
  __syncthreads();
  if (col < COLS) {
    int run = part_s[s][c];
    int x = lo;
    for (; x + 4 <= hi; x += 4) {  // four loads in flight
      int t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = p[(size_t)(x + i) * COLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[(size_t)(x + i) * COLS] = run;
        run += t[i];
      }
    }
    for (; x < hi; ++x) {
      const int t = p[(size_t)x * COLS];
      p[(size_t)x * COLS] = run;
      run += t;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    prefix_tables_write_kernel(const int32_t* __restrict__ bucket,
                               const int32_t* __restrict__ sym1,
                               const int32_t* __restrict__ sym2,
                               const int32_t* __restrict__ n_tok, int32_t* __restrict__ p18,
                               int32_t* __restrict__ p256, const int32_t* __restrict__ scratch,
                               int n, int n_q, int NX) {
  __shared__ int base_s[COLS];
  __shared__ int hist_s[MAX_ROWS][NBINS];
  __shared__ int warp_s[WARPS][NB];
  __shared__ __align__(16) int stage_s[WARPS][32 * NB];
  const int w = blockIdx.y, x = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Tile tl = tile_of(w, x, n);
  if (tl.r0 >= tl.r1) return;  // the whole block: past the lane's last tile
  const int nt = lane_n_tok(n_tok, w, n);
  const int lo = max(tl.a, 0), hi = min(tl.b, nt);  // tokens that count
  const long long L0 = (long long)w * (n + 1);
  const size_t off = (size_t)w * n;

  // The offsets: this tile's exclusive sums, or the lane's totals.
  const int32_t* src =
      scratch + ((size_t)w * (NX + 1) + (x < valid_tiles(w, n, nt) ? x : NX)) * COLS;
  for (int c = tid; c < COLS; c += THREADS) base_s[c] = src[c];
  // P256 rows rho0..rho1 - 1: those whose stride ends (256 rho - 1) in
  // [a, b), and at the lane's tail every row up to n_q - 1.
  const int rho0 = (tl.a + 1 + STRIDE - 1) / STRIDE;
  const int rho1 = tl.b == n ? n_q : (tl.b + 1 + STRIDE - 1) / STRIDE;
  const int n_rows = rho1 - rho0;
  for (int i = tid; i < n_rows * NBINS; i += THREADS) hist_s[i / NBINS][i % NBINS] = 0;

  // This warp's groups of 32 rows: lane j holds the bucket of row G + j.
  int bk[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const long long R = tl.frame + (warp * GROUPS + g) * 32 + lane;
    const int t = (int)(R - L0 - 1);
    bk[g] = R >= tl.r0 && R < tl.r1 && t >= 0 && t < nt ? bucket[off + t] : -1;
  }
  int s1[TILE / THREADS], s2[TILE / THREADS];
#pragma unroll
  for (int i = 0; i < TILE / THREADS; ++i) {
    const int t = lo + tid + i * THREADS;
    s1[i] = t < hi ? sym1[off + t] : NBINS;
    s2[i] = t < hi ? sym2[off + t] : NBINS;
  }
  __syncthreads();  // bins zeroed, offsets loaded

  // Symbols by the first row that counts them: token t counts in rows
  // rho > t / 256.
#pragma unroll
  for (int i = 0; i < TILE / THREADS; ++i) {
    const int t = lo + tid + i * THREADS;
    const int r = max(t / STRIDE + 1 - rho0, 0);
    if (t < hi && r < n_rows) {
      if ((unsigned)s1[i] < (unsigned)NBINS) atomicAdd(&hist_s[r][s1[i]], 1);
      if ((unsigned)s2[i] < (unsigned)NBINS) atomicAdd(&hist_s[r][s2[i]], 1);
    }
  }
  int cnt = 0;  // lane k < 18: bucket k over the warp's rows
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int c = __popc(__ballot_sync(FULL, bk[g] == k));
      if (lane == k) cnt += c;
    }
  }
  if (lane < NB) warp_s[warp][lane] = cnt;
  __syncthreads();

  for (int c = tid; c < NBINS; c += THREADS) {
    int run = base_s[NB + c];
    int32_t* out = p256 + ((size_t)w * n_q + rho0) * NBINS + c;
    for (int r = 0; r < n_rows; ++r) {
      run += hist_s[r][c];
      __stcs(out + (size_t)r * NBINS, run);
    }
  }

  int mine = 0;  // lane k < 18: bucket k before this warp's first row
  if (lane < NB) {
    mine = base_s[lane];
    for (int ww = 0; ww < warp; ++ww) mine += warp_s[ww][lane];
  }
  int base[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) base[k] = __shfl_sync(FULL, mine, k);
  int* stage = stage_s[warp];
  const unsigned le = (2u << lane) - 1u;  // lanes 0..lane
  bool constant = false;                  // the stage holds the row of base
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const long long G = tl.frame + (warp * GROUPS + g) * 32;
    if (G + 32 <= tl.r0 || G >= tl.r1) continue;  // uniform over the warp
    const bool any = __any_sync(FULL, bk[g] >= 0);
    if (any || !constant) {
      int row[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const unsigned m = __ballot_sync(FULL, bk[g] == k);
        row[k] = base[k] + __popc(m & le);
        base[k] += __popc(m);
      }
      __syncwarp();  // the last group's stores have read the stage
      int2* st = reinterpret_cast<int2*>(stage + lane * NB);
#pragma unroll
      for (int q = 0; q < NB / 2; ++q) st[q] = make_int2(row[2 * q], row[2 * q + 1]);
      __syncwarp();
      constant = !any;
    }
    if (G >= tl.r0 && G + 32 <= tl.r1) {  // 18 whole lines
      int4* dst = reinterpret_cast<int4*>(p18 + G * NB);
      const int4* s4 = reinterpret_cast<const int4*>(stage);
#pragma unroll
      for (int j = lane; j < 32 * NB / 4; j += 32) __stcs(dst + j, s4[j]);
    } else {  // a lane's head or tail: row by row
      const long long R = G + lane;
      if (R >= tl.r0 && R < tl.r1) {
        int2* dst = reinterpret_cast<int2*>(p18 + R * NB);
        const int2* s2v = reinterpret_cast<const int2*>(stage + lane * NB);
#pragma unroll
        for (int q = 0; q < NB / 2; ++q) __stcs(dst + q, s2v[q]);
      }
    }
  }
}

}  // namespace

extern "C" int zt_prefix_tables(const void* bucket, const void* sym1, const void* sym2,
                                const void* n_tok, void* p18, void* p256, void* scratch, int W,
                                int n, void* stream) {
  if (W < 0 || n < 1 || n >= (1 << 30) || (uintptr_t)p18 % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_q = n / STRIDE + 2;
  const int NX = (n + 1 + TILE - 1) / TILE + 1;  // tiles a lane at most
  if (W > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(NX, W);
    prefix_tables_count_kernel<<<grid, THREADS, 0, st>>>(
        (const int32_t*)bucket, (const int32_t*)sym1, (const int32_t*)sym2,
        (const int32_t*)n_tok, (int32_t*)scratch, n, NX);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    prefix_tables_scan_kernel<<<dim3((COLS + 31) / 32, W), SCAN_THREADS, 0, st>>>(
        (const int32_t*)n_tok, (int32_t*)scratch, n, NX);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    prefix_tables_write_kernel<<<grid, THREADS, 0, st>>>(
        (const int32_t*)bucket, (const int32_t*)sym1, (const int32_t*)sym2,
        (const int32_t*)n_tok, (int32_t*)p18, (int32_t*)p256, (const int32_t*)scratch, n, n_q,
        NX);
  }
  return (int)cudaGetLastError();
}
