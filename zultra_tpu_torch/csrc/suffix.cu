// One prefix-doubling round of the suffix arrays, for every segment of a
// batch: the suffix order by (rank_i, rank_{i+k}) (-1 past the end), ties
// by position, its dense ranks, and whether they are all distinct.
//
// Replaces no Pallas kernel: the JAX package runs the round as XLA's
// lax.sort of (rank, rank2, idx) (zultra_tpu/ops/suffix_jax.py:82), and the
// port ran it as torch.sort of packed int64 keys (cub's segmented radix
// sort over all 64 bits), a compare, a cumsum and a scatter.
//
// What bounds it on the card: the bytes of the ranks and the suffix order,
// read and written once, about 16 a position; with the two accesses that
// follow the order (rank_{i+k}, and the new rank's store) scattered over a
// segment's 4n bytes.
//
// What this design does about it: it sorts nothing it need not.
//   - Ranks are dense and below n, and the previous round's suffix order
//     already sorts each segment by (rank, position). A round only orders
//     the members of each group of equal rank by rank_{i+k}, stably; a
//     group of one is done. So the order is updated group by group.
//   - A segment whose ranks were all distinct after the round before
//     skips the round: its block reads the flag and returns, after copying
//     its ranks where the caller asked for a new row (a stored level). The
//     launches of all rounds stay in one CUDA graph; nothing waits for the
//     device.
// Two launches a round. The first: one block a segment, walks over its
// suffix order:
//   1. Small groups. Tiles of up to TILE entries, each cut at a group
//      boundary. A tile's groups are ordered in shared memory by one
//      stable block radix sort of (group in the tile, rank_{i+k} + 1)
//      (30 bits); rank_{i+k} is loaded only for members of groups of two
//      or more. A tile of singletons keeps its order. Where the segment
//      has no group of more than TILE entries (a test of n / 32 pairs of
//      ranks LARGE_GAP apart finds every such group), the walk also ranks:
//      a boundary where the sorted key changes, a block scan carried over
//      the tiles, the tile's order and dense ranks written in place, and
//      the round ends there. Else it writes the order to scratch and notes
//      each larger group for walk 2 (at most MAX_BIG of them a segment).
//   2. Large groups. Manber and Myers' order: the suffixes p with p + k >=
//      n in position order, then p = sa[j] - k for j along the previous
//      order, are sorted by (rank_{p+k}, p) already. Walking that
//      sequence, each member of a large group takes the next slot of its
//      group: a per-warp __match_any_sync and a scan of per-warp counts
//      over the block keep the walk's order.
//   3. Ranks. The new order's group boundaries (the old rank or
//      rank_{i+k} changes), a block scan of them carried over the tiles:
//      the dense ranks in suffix order, kept for the next round. A
//      segment is distinct when the count reaches n.
// The second launch stores the ranks in position order (rank_scatter_kernel).
// The first round has no previous order: a stable counting sort of the
// symbols makes one first (bytes by 256 counters; each symbol >= 256, a
// sentinel, unique in its row, by a bitmap of them), with the symbols'
// dense ranks as the group ranks.
// State between rounds (the wrapper's, ops/suffix_cuda.py): sa and the
// ranks in suffix order (rsa), both updated in place, the flags and a
// count of the rounds each segment ran. Scratch: the new order and its
// rank_{i+k} a segment (2n words). The plain model of this schedule is
// ops/suffix_cuda.py::doubling_model.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // 4096 entries a tile
constexpr int MAX_N = 1 << 17;         // positions a segment, at most
constexpr int KEY2_BITS = 18;          // rank_{i+k} + 1 <= 256 + MAX_N < 2^18
constexpr uint32_t KEY2_MASK = (1u << KEY2_BITS) - 1u;
constexpr int MAX_BIG = 32;            // groups above TILE a segment: < MAX_N / (TILE + 1) + 1
constexpr int ROWS = ITEMS * WARPS;    // warp rows of a walk-2 step
constexpr int NOT_BYTE = 256;          // the first round's sort key of a sentinel
// A group of more than TILE entries holds two entries LARGE_GAP apart, the
// first at a multiple of 32 (so a test of n / 32 pairs finds every one).
constexpr int LARGE_GAP = TILE + 1 - 32;
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_ITEMS = 16;
constexpr int SCATTER_TILE = SCATTER_THREADS * SCATTER_ITEMS;

using TileSort = cub::BlockRadixSort<uint32_t, THREADS, ITEMS, int32_t>;
using Scan = cub::BlockScan<int32_t, THREADS>;

struct MaxOp {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};

struct Smem {
  union {
    typename TileSort::TempStorage sort;
    typename Scan::TempStorage scan;
  } cub;
  union {
    int32_t ranks[TILE + 1];          // walk 1: the tile's old ranks, and the next entry's
    int32_t counts[ROWS][MAX_BIG];    // walk 2: a step's counts a warp row, then its bases
    struct {
      uint32_t bits[MAX_N / 32];      // first round: which sentinels the row holds
      int32_t before[THREADS];        // set bits before each thread's ITEMS words
    } sent;
  } u;
  int32_t edge_a[THREADS], edge_b[THREADS];  // each thread's first or last item, for its neighbours
  int32_t cursor_byte[256], dense_byte[256];
  int32_t big_lo[MAX_BIG], big_hi[MAX_BIG], big_rank[MAX_BIG], cursor[MAX_BIG];
  int32_t n_big, t1, found;
};

// Set bits of the sentinel bitmap below bit v.
__device__ __forceinline__ int32_t sentinels_below(const Smem& sm, uint32_t v) {
  const int w = v >> 5, t = w / ITEMS;
  int32_t r = sm.u.sent.before[t];
  for (int x = t * ITEMS; x < w; ++x) r += __popc(sm.u.sent.bits[x]);
  return r + __popc(sm.u.sent.bits[w] & ((1u << (v & 31)) - 1u));
}

__device__ __forceinline__ uint32_t sentinel_bit(uint32_t s, int n) {
  return min(s - 256u, (uint32_t)(n - 1));  // a symbol outside the contract stays in the row
}

// The first round's order: positions by (symbol, position) into sa, the
// symbols' dense ranks in suffix order into rsa and in position order into
// grp. Bytes by a stable counting sort, tile by tile (a 9-bit block sort
// gives each byte's run in the tile; a cursor a byte carries the runs);
// sentinels straight to their place after the bytes.
__device__ void first_order(Smem& sm, const int32_t* data, int32_t* sa, int32_t* rsa,
                            int32_t* grp, int n) {
  const int tid = threadIdx.x;
  const int n_words = (n + 31) >> 5;
  for (int i = tid; i < 256; i += THREADS) sm.cursor_byte[i] = 0;
  for (int w = tid; w < n_words; w += THREADS) sm.u.sent.bits[w] = 0;
  __syncthreads();
  for (int p = tid; p < n; p += THREADS) {
    const uint32_t s = (uint32_t)data[p];
    if (s < 256u) {
      atomicAdd(&sm.cursor_byte[s], 1);
    } else {
      const uint32_t v = sentinel_bit(s, n);
      atomicOr(&sm.u.sent.bits[v >> 5], 1u << (v & 31));
    }
  }
  __syncthreads();
  const int32_t count = tid < 256 ? sm.cursor_byte[tid] : 0;
  int32_t start, n_bytes, dense, n_dense, ones = 0, before, n_sent;
  Scan(sm.cub.scan).ExclusiveSum(count, start, n_bytes);
  __syncthreads();
  Scan(sm.cub.scan).ExclusiveSum(count > 0 ? 1 : 0, dense, n_dense);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int w = tid * ITEMS + j;
    if (w < n_words) ones += __popc(sm.u.sent.bits[w]);
  }
  Scan(sm.cub.scan).ExclusiveSum(ones, before, n_sent);
  if (tid < 256) {
    sm.cursor_byte[tid] = start;
    sm.dense_byte[tid] = dense;
  }
  sm.u.sent.before[tid] = before;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += TILE) {
    uint32_t key[ITEMS];
    int32_t pos[ITEMS], run_start[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = t0 + tid * ITEMS + j;
      const uint32_t s = p < n ? (uint32_t)data[p] : 0u;
      key[j] = p < n ? (s < 256u ? s : (uint32_t)NOT_BYTE) : 511u;
      pos[j] = p < n ? p : -1;
    }
    TileSort(sm.cub.sort).Sort(key, pos, 0, 9);  // stable: positions in order within a byte
    sm.edge_a[tid] = (int32_t)key[ITEMS - 1];
    sm.edge_b[tid] = (int32_t)key[0];
    __syncthreads();
    uint32_t prev = tid ? (uint32_t)sm.edge_a[tid - 1] : 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      run_start[j] = key[j] != prev ? tid * ITEMS + j : 0;
      prev = key[j];
    }
    Scan(sm.cub.scan).InclusiveScan(run_start, run_start, MaxOp());
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = pos[j];
      if (p < 0) continue;
      int32_t dest, d;
      if (key[j] < 256u) {
        dest = sm.cursor_byte[key[j]] + (tid * ITEMS + j - run_start[j]);
        d = sm.dense_byte[key[j]];
      } else {
        const int32_t below = sentinels_below(sm, sentinel_bit((uint32_t)data[p], n));
        dest = n_bytes + below;
        d = n_dense + below;
      }
      sa[dest] = p;
      rsa[dest] = d;
      grp[p] = d;
    }
    __syncthreads();  // every cursor read; then each byte run's last item moves its cursor
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const uint32_t next = j + 1 < ITEMS ? key[j + 1]
                            : (tid + 1 < THREADS ? (uint32_t)sm.edge_b[tid + 1] : 0xFFFFFFFFu);
      if (key[j] < 256u && next != key[j])
        sm.cursor_byte[key[j]] += tid * ITEMS + j - run_start[j] + 1;
    }
    __syncthreads();
  }
}

// Walk 1: the groups of at most TILE entries, ordered by rank_{i+k} in
// shared memory. Fused (the segment has no larger group), each tile's new
// order and dense ranks go to sa and rsa in place, the ranks counted on
// from the tiles before; -> the count. Else into nsa / nk2 (rank_{i+k} of
// each new entry; unwritten for a tile of singletons, whose boundaries
// need none), the larger groups noted in sm.big_*, for walks 2 and 3.
__device__ int32_t order_small_groups(Smem& sm, const int32_t* rank, int32_t* sa, int32_t* rsa,
                                      int32_t* nsa, int32_t* nk2, int n, int k, bool fused) {
  const int tid = threadIdx.x;
  if (tid == 0) sm.n_big = 0;
  int t0 = 0;
  int32_t carry = 0;
  while (t0 < n) {
    const int loaded = min(TILE + 1, n - t0);
    for (int i = tid; i < loaded; i += THREADS) sm.u.ranks[i] = rsa[t0 + i];
    __syncthreads();
    if (tid == 0) {
      int t1 = n, big = 0;
      if (n - t0 > TILE) {
        const int last = sm.u.ranks[TILE - 1];
        if (sm.u.ranks[TILE] != last) {
          t1 = t0 + TILE;
        } else {  // cut before the group that runs past the tile
          int lo = 0, hi = TILE - 1;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (sm.u.ranks[mid] < last) lo = mid + 1; else hi = mid;
          }
          t1 = t0 + lo;
          big = lo == 0;
        }
      }
      sm.t1 = t1;
      sm.found = big;
    }
    __syncthreads();
    if (sm.found) {  // a group of more than TILE entries starts at t0: find its end
      const int32_t r0 = sm.u.ranks[0];
      __syncthreads();
      if (tid == 0) sm.t1 = n;
      __syncthreads();
      for (int base = t0 + TILE; base < n; base += TILE) {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const int i = base + j * THREADS + tid;
          if (i < n && rsa[i] != r0) atomicMin(&sm.t1, i);
        }
        __syncthreads();
        const bool done = sm.t1 < n;
        __syncthreads();
        if (done) break;
      }
      const int end = sm.t1;
      if (tid == 0) {
        const int c = sm.n_big++;
        sm.big_lo[c] = t0;
        sm.big_hi[c] = end;
        sm.big_rank[c] = r0;
      }
      t0 = end;
      __syncthreads();
      continue;
    }
    const int t1 = sm.t1, len = t1 - t0;
    const int32_t r0 = sm.u.ranks[0];
    const int32_t g_max = sm.u.ranks[len - 1] - r0;
    if (g_max + 1 == len) {  // singletons alone: the order stands, each a rank
      if (fused) {
        for (int i = tid; i < len; i += THREADS) rsa[t0 + i] = carry + i;
      } else {
        for (int i = tid; i < len; i += THREADS) nsa[t0 + i] = sa[t0 + i];
      }
      carry += len;
    } else {
      uint32_t key[ITEMS];
      int32_t pos[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int i = tid * ITEMS + j;
        if (i < len) {
          const int32_t r = sm.u.ranks[i];
          const bool single = (i == 0 || sm.u.ranks[i - 1] != r)
                              && (i + 1 == len || sm.u.ranks[i + 1] != r);
          const int p = sa[t0 + i];
          const int32_t r2 = !single && p + k < n ? rank[p + k] : -1;
          key[j] = ((uint32_t)(r - r0) << KEY2_BITS) | (uint32_t)(r2 + 1);
          pos[j] = p;
        } else {
          key[j] = 0xFFFFFFFFu;  // past the tile: after every key of it
          pos[j] = 0;
        }
      }
      const int end_bit = KEY2_BITS + 32 - __clz(g_max);
      if (fused) {  // a boundary where the key (group, rank_{i+k}) changes
        TileSort(sm.cub.sort).Sort(key, pos, 0, end_bit);
        sm.edge_a[tid] = (int32_t)key[ITEMS - 1];
        __syncthreads();
        uint32_t prev = tid ? (uint32_t)sm.edge_a[tid - 1] : ~key[0];
        int32_t b[ITEMS], tile_total;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          b[j] = tid * ITEMS + j < len && key[j] != prev;
          prev = key[j];
        }
        Scan(sm.cub.scan).InclusiveSum(b, b, tile_total);
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const int i = tid * ITEMS + j;
          if (i < len) {
            sa[t0 + i] = pos[j];
            rsa[t0 + i] = carry + b[j] - 1;
          }
        }
        carry += tile_total;
      } else {
        TileSort(sm.cub.sort).SortBlockedToStriped(key, pos, 0, end_bit);
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          const int i = j * THREADS + tid;
          if (i < len) {
            nsa[t0 + i] = pos[j];
            nk2[t0 + i] = (int32_t)(key[j] & KEY2_MASK) - 1;
          }
        }
      }
    }
    t0 = t1;
    __syncthreads();
  }
  return carry;
}

__device__ __forceinline__ int big_group(const Smem& sm, int n_big, int32_t r) {
  int lo = 0, hi = n_big;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sm.big_rank[mid] < r) lo = mid + 1; else hi = mid;
  }
  return lo < n_big && sm.big_rank[lo] == r ? lo : -1;
}

// Walk 2: the large groups, each member to the next slot of its group
// along Manber and Myers' order (rank_{p+k}, p): the kk = min(k, n)
// suffixes past n - k first, then sa[j] - k for each j with sa[j] >= k.
// grp: the group ranks in position order.
__device__ void order_large_groups(Smem& sm, const int32_t* grp, const int32_t* sa,
                                   const int32_t* rsa, int32_t* nsa, int32_t* nk2, int n, int k) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n_big = sm.n_big;
  if (tid < MAX_BIG) sm.cursor[tid] = 0;
  const int kk = min(k, n), total = kk + n;
  for (int base = 0; base < total; base += TILE) {
    int32_t c[ITEMS], p[ITEMS], r2[ITEMS], ord[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int e = base + j * THREADS + tid;
      c[j] = -1;
      p[j] = 0;
      r2[j] = -1;
      if (e < total) {
        bool valid = true;
        if (e < kk) {
          p[j] = n - kk + e;
        } else {
          const int j_pos = sa[e - kk];
          valid = j_pos >= k;
          p[j] = j_pos - k;
          r2[j] = rsa[e - kk];
        }
        if (valid) c[j] = big_group(sm, n_big, grp[p[j]]);
      }
    }
    for (int x = tid; x < ROWS * MAX_BIG; x += THREADS) (&sm.u.counts[0][0])[x] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, c[j]);
      ord[j] = __popc(peers & below);
      if (c[j] >= 0 && ord[j] == 0) sm.u.counts[j * WARPS + warp][c[j]] = __popc(peers);
    }
    __syncthreads();
    if (tid < n_big) {  // rows in the walk's order: item j, then warp
      int32_t run = sm.cursor[tid];
      for (int row = 0; row < ROWS; ++row) {
        const int32_t t = sm.u.counts[row][tid];
        sm.u.counts[row][tid] = run;
        run += t;
      }
      sm.cursor[tid] = run;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (c[j] < 0) continue;
      const int dest = sm.big_lo[c[j]] + sm.u.counts[j * WARPS + warp][c[j]] + ord[j];
      nsa[dest] = p[j];
      nk2[dest] = r2[j];
    }
    __syncthreads();
  }
}

// Walk 3: dense ranks of the new order; sa and rsa in place. -> the
// number of ranks.
__device__ int32_t rerank(Smem& sm, int32_t* sa, int32_t* rsa, const int32_t* nsa,
                          const int32_t* nk2, int n) {
  const int tid = threadIdx.x;
  int32_t carry = 0, prev_r = -1, prev_k2 = 0;
  for (int t0 = 0; t0 < n; t0 += TILE) {
    int32_t r[ITEMS], k2[ITEMS], p[ITEMS], b[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = t0 + tid * ITEMS + j;
      r[j] = i < n ? rsa[i] : -2;
      k2[j] = i < n ? nk2[i] : 0;
      p[j] = i < n ? nsa[i] : 0;
    }
    sm.edge_a[tid] = r[ITEMS - 1];
    sm.edge_b[tid] = k2[ITEMS - 1];
    __syncthreads();
    int32_t pr = tid ? sm.edge_a[tid - 1] : prev_r;
    int32_t pk = tid ? sm.edge_b[tid - 1] : prev_k2;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      b[j] = t0 + tid * ITEMS + j < n && (r[j] != pr || k2[j] != pk);
      pr = r[j];
      pk = k2[j];
    }
    int32_t tile_total;
    Scan(sm.cub.scan).InclusiveSum(b, b, tile_total);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = t0 + tid * ITEMS + j;
      if (i < n) {
        const int32_t d = carry + b[j] - 1;
        sa[i] = p[j];
        rsa[i] = d;
      }
    }
    prev_r = sm.edge_a[THREADS - 1];
    prev_k2 = sm.edge_b[THREADS - 1];
    carry += tile_total;
    __syncthreads();
  }
  return carry;
}

__global__ void __launch_bounds__(THREADS, 2)
suffix_round_kernel(const int32_t* rank_in, int32_t* rank_out, int32_t* sa, int32_t* rsa,
                    uint8_t* distinct, int32_t* rounds, int32_t* scratch, int n, int k,
                    int first) {
  __shared__ Smem sm;
  const int s = blockIdx.x;
  const size_t off = (size_t)s * n;
  rank_in += off;
  rank_out += off;
  sa += off;
  rsa += off;
  int32_t* nsa = scratch + 2 * off;
  int32_t* nk2 = nsa + n;
  if (!first && distinct[s]) {  // the round is an identity here
    if (rank_out != rank_in)
      for (int i = threadIdx.x; i < n; i += THREADS) rank_out[i] = rank_in[i];
    return;
  }
  const int32_t* grp = rank_in;
  if (first) {
    first_order(sm, rank_in, sa, rsa, rank_out, n);
    grp = rank_out;
  }
  bool pair = false;
  for (int j = threadIdx.x * 32; j + LARGE_GAP < n; j += THREADS * 32)
    pair |= rsa[j] == rsa[j + LARGE_GAP];
  const bool fused = !__syncthreads_or(pair);
  int32_t ranks = order_small_groups(sm, rank_in, sa, rsa, nsa, nk2, n, k, fused);
  if (!fused) {
    __syncthreads();
    if (sm.n_big) order_large_groups(sm, grp, sa, rsa, nsa, nk2, n, k);
    __syncthreads();
    ranks = rerank(sm, sa, rsa, nsa, nk2, n);
  }
  if (threadIdx.x == 0) {
    distinct[s] = ranks == n;
    rounds[s] = first ? 1 : rounds[s] + 1;
  }
}

// The new ranks to position order, rank_out[sa[i]] = rsa[i], for each
// segment that ran the round (its count of rounds is ``ran``). A block a
// tile of SCATTER_TILE entries, the blocks in segment order: the segments
// being written at a time fit in L2, so the scattered 4-byte stores meet
// there before their sectors go to device memory. (Stored from the round's
// own blocks, 264 segments at a time, they took 0.8 ms of a 2.1-2.8 ms
// round of 512 segments on an H100.)
__global__ void __launch_bounds__(SCATTER_THREADS)
rank_scatter_kernel(const int32_t* sa, const int32_t* rsa, const int32_t* rounds,
                    int32_t* rank_out, int n, int ran, int tiles) {
  const int s = blockIdx.x / tiles;
  if (rounds[s] != ran) return;
  const size_t off = (size_t)s * n;
  const int lo = (blockIdx.x - s * tiles) * SCATTER_TILE;
  int32_t p[SCATTER_ITEMS], d[SCATTER_ITEMS];
#pragma unroll
  for (int j = 0; j < SCATTER_ITEMS; ++j) {
    const int i = lo + j * SCATTER_THREADS + threadIdx.x;
    p[j] = i < n ? sa[off + i] : -1;
    d[j] = i < n ? rsa[off + i] : 0;
  }
#pragma unroll
  for (int j = 0; j < SCATTER_ITEMS; ++j)
    if (p[j] >= 0) rank_out[off + p[j]] = d[j];
}

}  // namespace

// rank_in, rank_out (S, n) int32 (the same tensor past the first round
// allowed; the first round's rank_in is the symbols, and its rank_out
// another tensor), sa and rsa (S, n) int32, distinct (S,) bool and rounds
// (S,) int32: the state, in place (written whole by the first round);
// scratch (S, 2, n) int32. 1 <= n <= MAX_N.
extern "C" int zt_suffix_round(const void* rank_in, void* rank_out, void* sa, void* rsa,
                               void* distinct, void* rounds, void* scratch, int S, int n,
                               int k, int first, void* stream) {
  if (S < 0 || n < 1 || n > MAX_N || k < 1) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  int level = 0;
  while ((1 << level) < k) ++level;
  suffix_round_kernel<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rank_in, (int32_t*)rank_out, (int32_t*)sa, (int32_t*)rsa,
      (uint8_t*)distinct, (int32_t*)rounds, (int32_t*)scratch, n, k, first);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + SCATTER_TILE - 1) / SCATTER_TILE;
  rank_scatter_kernel<<<S * tiles, SCATTER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sa, (const int32_t*)rsa, (const int32_t*)rounds, (int32_t*)rank_out, n,
      level + 1, tiles);
  return (int)cudaGetLastError();
}
