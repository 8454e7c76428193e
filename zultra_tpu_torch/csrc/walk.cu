// Lazy LCP-interval walk: the match finder's sequential stage.
//
// Replaces the TPU kernel zultra_tpu/ops/walk_pallas.py::_walk_kernel
// (reference algorithm: zultra src/matchfinder.c:98-155 tree build,
// :171-234 lazy interval-ascent walk).
//
// Each segment buffer is laid out as [HALO history | core | TAIL]
// (matchfinder_torch.build_segments); the walk emits up to 8 packed
// (len << 16 | off) rows for each core position, longest first.
//
// What bounds it on the card: walking one position is a chain of 5-7
// dependent loads into tables of 2n words a segment (0.5 MB at n =
// 65794), far more than a block's shared memory, so each is a round trip
// to L2 or device memory. A walk from position 0, as the reference runs
// it, is 65,794 such steps on one thread, half of them in the halo only
// to build the tables' state for the core.
//
// What this design does about it: it builds the walk's state at any
// position directly from the tree, without walking to it, and walks the
// core in chunks of `chunk` positions, all at once. Chunk j starts at
// h_j = halo + j * chunk from its own table, the canonical state at h_j
// (ops/walk_cuda.py::walk_chunks_model states it and why the rows come
// out exact). Three launches:
//   1. Sweep (one warp per segment, lane j for chunk j). The stack sweep
//      over the rank-order words, staged into shared memory by a
//      double-buffered bulk copy (cp.async.bulk on an mbarrier), so no
//      step waits on device memory. It writes the phase-0 table (parent
//      refs, leaf refs) and, as each interval closes, its word in every
//      chunk's table: VIS | the newest position below h_j in its subtree,
//      a running maximum per stack entry and lane, or its parent ref.
//   2. Park (one thread per (chunk, table word) of every segment). Each
//      position q < h_j gets its parked ref, exactly one store: from the
//      highest interval whose newest position is q, or from its leaf.
//   3. Walk (one thread per (segment, chunk)). The reference's position
//      step on the chunk's table over [h_j, h_j + chunk) of the core,
//      with each position's leaf loaded ahead from the phase-0 table and
//      its interval's word prefetched; it writes all 8 words of each row.
// What still bounds it: the chunk walk's dependent loads (chunk
// positions on one thread), and the sweep's steps on one warp: a chain
// of dependent instructions that one warp cannot overlap. (An earlier
// version kept the stack's top two entries in registers, interleaved the
// chunks' interval words and walked a segment's chunks in one block: it
// was slower on every input, PERF.md §6.)

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
constexpr int STACK = 264;       // deeper than the 257 LCP values (0, 3..258) a stack holds
constexpr int CHUNKS_MAX = 32;   // one lane of the sweep's warp per chunk
constexpr int TILE = 4096;       // rank-order words a staged tile
constexpr int PARK_THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A segment's scratch, (J + 1) * 2n words: the phase-0 tree (T0: each
// interval's parent ref; P0: each position's leaf ref), then chunk j's
// interval words (Tc + j * n), then chunk j's position words (Pc + j * n).
struct Tables {
  uint32_t *T0, *P0, *Tc, *Pc;
  __device__ Tables(uint32_t* scratch, int seg, int J, int n) {
    T0 = scratch + (size_t)seg * (J + 1) * 2 * (size_t)n;
    P0 = T0 + n;
    Tc = P0 + n;
    Pc = Tc + (size_t)J * n;
  }
};

struct __align__(16) SweepSmem {
  uint64_t bar[2];
  uint32_t buf[2][TILE + 4];  // a staged tile, up to 3 words ahead for alignment
  uint32_t stack[STACK];
  int32_t mx[STACK][CHUNKS_MAX];  // each entry's newest position below h_lane
};

// Stage the words [t * TILE, min((t + 1) * TILE, n)) into buffer t & 1:
// word lo + k at buf[off + k], where off aligns the copy's body to 16
// bytes. The aligned body comes by one bulk copy that completes on the
// buffer's mbarrier; the at most 3 words on either side by plain loads.
__device__ void stage(SweepSmem& sm, const uint32_t* salcp, int n, int t, int off, int lane) {
  const int b = t & 1;
  const int lo = t * TILE;
  const int len = min(TILE, n - lo);
  const uint32_t* g = salcp + lo;
  const int head = min(len, (4 - off) & 3);
  const int body = (len - head) & ~3;
  uint32_t* s = sm.buf[b] + off;
  if (lane == 0) {
    // The buffer's last reads were the generic proxy's; order them before
    // the bulk copy's writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(&sm.bar[b])), "r"((uint32_t)body * 4) : "memory");
    if (body > 0) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr(s + head)), "l"(g + head), "r"((uint32_t)body * 4),
          "r"(smem_addr(&sm.bar[b])) : "memory");
    }
  }
  for (int k = lane; k < head; k += 32) s[k] = g[k];
  for (int k = head + body + lane; k < len; k += 32) s[k] = g[k];
}

__device__ __forceinline__ void wait_tile(SweepSmem& sm, int t) {
  const uint32_t parity = (uint32_t)(t >> 1) & 1u;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(&sm.bar[t & 1])), "r"(parity) : "memory");
  }
}

// Launch 1: one warp per segment. Every lane runs the same stack sweep
// (broadcast shared reads); lane j keeps the newest position below h_j
// attached to each stack entry (for the top in a register) and writes
// chunk j's interval words. Lanes past the last chunk repeat its work,
// and every lane stores the phase-0 words, so that no store waits on a
// lane-dependent branch: lanes that store to one address store one value.
__global__ void __launch_bounds__(32)
    walk_sweep_kernel(const uint32_t* __restrict__ salcp_all, uint32_t* __restrict__ scratch,
                      int32_t* __restrict__ nidx_all, int n, int halo, int chunk, int J) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SweepSmem& sm = *reinterpret_cast<SweepSmem*>(smem_raw);
  const int seg = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* salcp = salcp_all + (size_t)seg * n;
  const Tables tb(scratch, seg, J, n);
  const int jl = min(lane, J - 1);
  uint32_t* Tl = tb.Tc + (size_t)jl * n;  // chunk jl's interval words
  const int h = halo + jl * chunk;

  const int off = (int)(((uintptr_t)salcp >> 2) & 3);
  const int ntiles = (n + TILE - 1) / TILE;
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&sm.bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&sm.bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  stage(sm, salcp, n, 0, off, lane);
  if (ntiles > 1) stage(sm, salcp, n, 1, off, lane);
  __syncwarp();

  int sp = 0;         // the top's depth; the root is entry 0
  uint32_t top = 0;   // sm.stack[sp], kept in a register
  int mtop = -1;      // sm.mx[sp][lane], kept in a register (-1: none yet)
  sm.stack[0] = 0;
  tb.T0[0] = 0;
  Tl[0] = 0;
  uint32_t nidx = 1;
  uint32_t prev_pos = 0;

  // The top entry closes under `parent`: its words in the phase-0 table
  // and in chunk jl's.
  auto write = [&](uint32_t parent) {
    const uint32_t idx = top & POS_M;
    tb.T0[idx] = parent;
    Tl[idx] = mtop >= 0 ? (VIS | (uint32_t)mtop) : parent;
  };
  auto attach = [&](uint32_t q) {
    tb.P0[q] = top;
    mtop = max(mtop, (int)q < h ? (int)q : -1);
  };

  for (int t = 0; t < ntiles; ++t) {
    wait_tile(sm, t);
    const uint32_t* w = sm.buf[t & 1] + off - t * TILE;  // w[i]: word i of the segment
    const int i_end = min(n, (t + 1) * TILE);
    int i = t * TILE;
    if (t == 0) prev_pos = w[i++] & POS_M;
    uint32_t next = i < i_end ? w[i] : 0;  // each word is read a step ahead
    for (; i < i_end; ++i) {
      const uint32_t packed = next;
      if (i + 1 < i_end) next = w[i + 1];
      const uint32_t next_lcp = packed & LCP_M;
      if (next_lcp > (top & LCP_M)) {
        sm.mx[sp][lane] = mtop;
        top = next_lcp | nidx++;
        sm.stack[++sp] = top;
        mtop = -1;
      }
      attach(prev_pos);
      while (next_lcp < (top & LCP_M)) {
        const uint32_t below = sm.stack[sp - 1];
        if (next_lcp > (below & LCP_M)) {
          // A new entry takes the closed one's place as its parent and
          // keeps its maxima.
          const uint32_t parent = next_lcp | nidx++;
          write(parent);
          top = parent;
          sm.stack[sp] = top;
        } else {
          // The entry below is the parent and takes the maxima by max.
          write(below);
          top = below;
          --sp;
          mtop = max(mtop, sm.mx[sp][lane]);
        }
      }
      prev_pos = packed & POS_M;
    }
    __syncwarp();  // every lane is done with this buffer
    if (t + 2 < ntiles) stage(sm, salcp, n, t + 2, off, lane);
  }
  attach(prev_pos);
  while (sp > 0) {
    const uint32_t below = sm.stack[sp - 1];
    write(below);
    top = below;
    --sp;
    mtop = max(mtop, sm.mx[sp][lane]);
  }
  if (lane == 0) nidx_all[seg] = (int32_t)nidx;
}

// Launch 2: grid (word blocks, segment), one thread per (chunk j, word
// x), x fastest. As an interval (1 <= x < nidx), x parks its newest
// position q at its parent ref if it is the highest interval whose newest
// position is q; as a position below h_j, x keeps its leaf ref unless its
// leaf's newest position is itself.
__global__ void __launch_bounds__(PARK_THREADS)
    walk_park_kernel(uint32_t* scratch, const int32_t* __restrict__ nidx_all, int n, int halo,
                     int chunk, int J) {
  const int seg = blockIdx.y;
  const Tables tb(scratch, seg, J, n);
  const long long f = (long long)blockIdx.x * PARK_THREADS + threadIdx.x;
  const int j = (int)(f / n);
  const int x = (int)(f % n);
  if (j >= J) return;
  const uint32_t* Tj = tb.Tc + (size_t)j * n;
  uint32_t* Pj = tb.Pc + (size_t)j * n;
  if (x >= 1 && x < nidx_all[seg]) {
    const uint32_t v = Tj[x];
    if (v & VIS) {
      const uint32_t parent = tb.T0[x];
      if (Tj[parent & POS_M] != v) Pj[v & EXCL_VIS] = parent;
    }
  }
  if (x < halo + j * chunk) {
    const uint32_t leaf = tb.P0[x];
    if (Tj[leaf & POS_M] != (VIS | (uint32_t)x)) Pj[x] = leaf;
  }
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Launch 3: one thread per (segment, chunk), one thread a block (the
// chains are latency-bound and would diverge within a warp).
__global__ void __launch_bounds__(1)
    walk_chunk_kernel(uint32_t* scratch, int32_t* __restrict__ rows_all, int n, int halo,
                      int core_len, int chunk, int J) {
  const int seg = blockIdx.x / J;
  const int j = blockIdx.x % J;
  const Tables tb(scratch, seg, J, n);
  const uint32_t* __restrict__ P0 = tb.P0;
  uint32_t* T = tb.Tc + (size_t)j * n;
  uint32_t* P = tb.Pc + (size_t)j * n;
  int32_t* rows = rows_all + (size_t)seg * core_len * NMATCH;
  const int lo = halo + j * chunk;
  const int hi = min(lo + chunk, halo + core_len);

  // Leaves are read-only here: each is loaded two steps ahead, and its
  // interval's word prefetched one step ahead.
  uint32_t ref1 = P0[lo];
  uint32_t ref2 = lo + 1 < hi ? P0[lo + 1] : 0;
  for (int p = lo; p < hi; ++p) {
    uint32_t ref = ref1;
    ref1 = ref2;
    if (p + 2 < hi) ref2 = P0[p + 2];
    if (p + 1 < hi) prefetch_l1(&T[ref1 & POS_M]);
    int32_t* row = rows + (size_t)(p - halo) * NMATCH;
    int count = 0;
    P[p] = 0;
    uint32_t sref = T[ref & POS_M];
    // Ascend to the closest visited ancestor (or the root), marking every
    // interval on the way as visited by p.
    while (sref & LCP_M) {
      T[ref & POS_M] = (uint32_t)p | VIS;
      ref = sref;
      sref = T[sref & POS_M];
    }
    if (sref == 0) {
      if (ref != 0) T[ref & POS_M] = (uint32_t)p | VIS;
    } else {
      uint32_t match_pos = sref & EXCL_VIS;
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
        if (count < NMATCH && off <= MAX_OFFSET) {
          row[count++] = (int32_t)(((ref >> LCP_SHIFT) << 16) | (uint32_t)off);
        }
        if (s2 == 0) break;
        ref = s2;
        match_pos = T[ref & POS_M] & EXCL_VIS;
      }
    }
    for (int k = count; k < NMATCH; ++k) row[k] = 0;
  }
}

}  // namespace

extern "C" int zt_walk(const void* salcp, void* tables, void* nidx, void* rows, int S, int n,
                       int halo, int core_len, int chunk, void* stream) {
  if (S <= 0 || core_len <= 0) return (int)cudaGetLastError();
  if (chunk < 1 || halo < 0 || n < 1 || halo + core_len > n || n > (int)POS_M || S > 65535)
    return (int)cudaErrorInvalidValue;
  const int J = (core_len + chunk - 1) / chunk;
  if (J > CHUNKS_MAX) return (int)cudaErrorInvalidValue;
  // Raise the sweep's shared memory limit once per device (a host call
  // that would otherwise cost every launch).
  static bool allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(walk_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(SweepSmem));
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* tab = (uint32_t*)tables;
  int32_t* ni = (int32_t*)nidx;
  walk_sweep_kernel<<<S, 32, sizeof(SweepSmem), st>>>((const uint32_t*)salcp, tab, ni, n, halo,
                                                      chunk, J);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long park_words = (long long)n * J;
  walk_park_kernel<<<dim3((unsigned)((park_words + PARK_THREADS - 1) / PARK_THREADS), S),
                     PARK_THREADS, 0, st>>>(tab, ni, n, halo, chunk, J);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  walk_chunk_kernel<<<S * J, 1, 0, st>>>(tab, (int32_t*)rows, n, halo, core_len, chunk, J);
  return (int)cudaGetLastError();
}
