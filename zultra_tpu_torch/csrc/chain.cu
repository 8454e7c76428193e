// Greedy token chain: marks every position of the hop chain
// p0 = start, p_{k+1} = p_k + max(step[p_k], 1), while p_k < length.
//
// Replaces the TPU kernel zultra_tpu/ops/chain_pallas.py::_chain_kernel
// (token boundaries of zultra src/blockdeflate.c:333-361), used by the
// block splitter and by every convergence pass of the block planner.
//
// What bounds it on the card: each hop's address depends on the value
// loaded by the previous hop, so a lane followed from its start is one
// chain of dependent loads, a few hundred thousand long on a 2 MiB lane,
// and one thread of one SM does all of it while the card idles.
//
// What this design does about it: it cuts the chain where it starts.
// Two chains that share one position are identical from there on, so a
// chain started a few hundred positions early almost always lands on the
// true one, and whether it did can be checked exactly. Each lane is cut
// into segments [a_j, b_j) of `seg` positions; two launches follow.
//   1. Speculate (one thread per segment, all lanes at once). A block of
//      T threads takes T consecutive segments of one lane and stages
//      their step values, with the `warm` positions below them, into
//      shared memory in one bulk asynchronous copy (TMA cp.async.bulk,
//      completing on an mbarrier; up to 227 KB a block). Each thread
//      chases hops at shared-memory latency from max(start, a_j - warm),
//      records F_j (its first position at or past a_j) and X_j (its first
//      at or past min(b_j, length)), and marks [a_j, b_j) in shared
//      memory; the block writes every byte of its range, 0 or 1. A chain
//      that started at `start` is the true one (EXACT). Segments wholly
//      below `start` or at or past `length` are NONE, all 0.
//   2. Resolve (one block per lane, its segments in order, carrying E,
//      the true chain's first position in the segment at hand). Where
//      E = F_j the speculation is the true chain from a_j on: ANCHORED,
//      E = X_j, O(1); the block finds the next segment where F_j differs
//      from X_{j-1} by a warp ballot over flags in shared memory.
//      Otherwise the block stages 8192 positions of steps and speculative
//      marks from that segment on into shared memory (as the first kernel
//      of this file staged its chunks), and one thread resolves the
//      segments that lie in them in order: an anchored one in O(1); any
//      other by walking the true chain from E until it lands on a
//      speculative mark (the chains merge: the marks from there on stand,
//      E = X_j; RERUN) or leaves the segment (UNMERGED: E = where it
//      left), marking the true positions as it goes. The block then
//      clears the speculative marks below each merge point.
// What still bounds it: the hops within a segment (seg + warm positions,
// one thread each) and the resolve pass over a lane's segments. A lane
// where nothing merges (all steps 3: two thirds of the speculations start
// on another residue mod 3) walks each such segment once more, one
// thread, shared memory, as the first kernel walked the whole lane.
// ops/chain_cuda.py::chain_segments_model is the same schedule in plain
// Python; its docstring states why the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Segment status (ops/chain_cuda.py ST_*).
constexpr int8_t ST_NONE = 0, ST_EXACT = 1, ST_ANCHORED = 2, ST_SPECULATED = 3, ST_RERUN = 4,
                 ST_UNMERGED = 5;
constexpr int SPEC_THREADS = 32;      // segments per speculate block, at most
constexpr int SMEM_MAX = 232448;      // 227 KB of dynamic shared memory a block (sm_90)
constexpr int FIX_THREADS = 256;
constexpr int FIX_CHUNK = 8192;       // positions staged per re-walk (at least one segment)
constexpr int TILE = 2048;            // segments whose F, X, status sit in shared memory
constexpr int HOP_MAX = 1 << 30;      // lanes are shorter, so p + hop never overflows
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int hop(int s) { return min(max(s, 1), HOP_MAX); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int lane_start(const int32_t* start, int lane, int n) {
  return min(max(start[lane], 0), n);
}

__device__ __forceinline__ int lane_end(const int32_t* length, int lane, int n) {
  return min(max(length[lane], 0), n);
}

// Copy len bytes from shared to global memory, 16 bytes a thread where
// the two addresses share their alignment (the caller placed `src` so).
__device__ void copy_out(uint8_t* dst, const uint8_t* src, int len, int tid, int nthreads) {
  const int head = min(len, (int)((16 - ((uintptr_t)dst & 15)) & 15));
  const int body = (len - head) & ~15;
  for (int i = tid; i < head; i += nthreads) dst[i] = src[i];
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  for (int i = tid; i < body / 16; i += nthreads) d4[i] = s4[i];
  for (int i = head + body + tid; i < len; i += nthreads) dst[i] = src[i];
}

// Shared memory of a speculate block of T threads: an mbarrier, the
// staged steps (T * seg + warm values, up to 3 more for alignment), the
// marks (T * seg bytes, up to 15 more for alignment).
__host__ __device__ __forceinline__ int spec_step_bytes(int T, int seg, int warm) {
  return ((T * seg + warm + 4) * 4 + 15) & ~15;
}
__host__ __device__ __forceinline__ int spec_smem(int T, int seg, int warm) {
  return 16 + spec_step_bytes(T, seg, warm) + ((T * seg + 32 + 15) & ~15);
}

// Launch 1: one thread per (lane, segment), T segments of one lane a block.
__global__ void __launch_bounds__(SPEC_THREADS)
    chain_spec_kernel(const int32_t* __restrict__ step_all, const int32_t* __restrict__ start,
                      const int32_t* __restrict__ length, uint8_t* __restrict__ marks_all,
                      int32_t* __restrict__ F_all, int32_t* __restrict__ X_all,
                      int8_t* __restrict__ status, int n, int nseg, int seg, int warm,
                      int blocks_per_lane) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = blockIdx.x / blocks_per_lane;
  const int j0 = (blockIdx.x % blocks_per_lane) * T;
  const int s = lane_start(start, lane, n);
  const int L = lane_end(length, lane, n);
  const int32_t* step = step_all + (size_t)lane * n;
  uint8_t* marks = marks_all + (size_t)lane * n;
  const int A = j0 * seg;                      // the block's positions: [A, Aend)
  const int Aend = (int)min((long long)(j0 + T) * seg, (long long)n);
  const int lo = max(s, A - warm);             // steps read: [lo, hi)
  const int hi = min(Aend, L);

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* sbuf = reinterpret_cast<int32_t*>(smem + 16);
  uint8_t* mbuf = smem + 16 + spec_step_bytes(T, seg, warm);
  // Shared and global addresses agree mod 16: sstep[p] is step[p] for p in
  // [lo, hi), smark[p] the mark of position p in [A, Aend).
  const int off = (int)(((uintptr_t)(step + lo) >> 2) & 3);
  const int32_t* sstep = sbuf + off - lo;
  uint8_t* smark = mbuf + (((uintptr_t)(marks + A)) & 15) - A;

  // The 16-byte-aligned interior of [lo, hi) comes by one bulk copy; the
  // at most 3 values on either side by plain loads.
  const int head = hi > lo ? min(hi - lo, (4 - off) & 3) : 0;
  const int body = hi > lo ? ((hi - lo - head) & ~3) : 0;
  const uint32_t bytes = (uint32_t)body * 4;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && bytes > 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(sstep + lo + head)), "l"(step + lo + head), "r"(bytes),
        "r"(smem_addr(bar)) : "memory");
  }
  if (hi > lo) {
    for (int i = tid; i < head; i += T) sbuf[off + i] = step[lo + i];
    for (int i = lo + head + body + tid; i < hi; i += T) sbuf[off + i - lo] = step[i];
  }
  {
    const int mlen = (Aend - A + 32 + 15) & ~15;
    uint4* m4 = reinterpret_cast<uint4*>(mbuf);
    for (int i = tid; i < mlen / 16; i += T) m4[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (bytes > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(bar)) : "memory");
    }
  }

  const int j = j0 + tid;
  if (j < nseg) {
    const int a = j * seg;
    const int lim = min(min(a + seg, n), L);
    int8_t st = ST_NONE;
    int F = -1, X = -1;
    if (s < L && a < L && a + seg > s) {
      int p = max(s, a - warm);
      st = p == s ? ST_EXACT : ST_SPECULATED;
      while (p < a) p += hop(sstep[p]);
      F = p;
      // Each hop's load is issued before the previous position's mark is
      // stored: a shared load behind a shared store waits for it.
      int v = p < lim ? sstep[p] : 0;
      while (p < lim) {
        const int q = p + hop(v);
        v = q < lim ? sstep[q] : 0;
        smark[p] = 1;
        p = q;
      }
      X = p;
    }
    const size_t g = (size_t)lane * nseg + j;
    F_all[g] = F;
    X_all[g] = X;
    status[g] = st;
  }
  __syncthreads();
  copy_out(marks + A, smark + A, Aend - A, tid, T);
}

// Launch 2: one block per lane, its segments in order.
__global__ void __launch_bounds__(FIX_THREADS)
    chain_fixup_kernel(const int32_t* __restrict__ step_all, const int32_t* __restrict__ start,
                       const int32_t* __restrict__ length, uint8_t* __restrict__ marks_all,
                       const int32_t* __restrict__ F_all, const int32_t* __restrict__ X_all,
                       int8_t* __restrict__ status, int n, int nseg, int seg, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sF = reinterpret_cast<int*>(smem);      // F_j of the tile
  int* sX = sF + TILE;                         // X_{j-1} of the tile, then X_j at + 1
  int& sh_E = sX[TILE + 1];                    // a round's results, from thread 0
  int& sh_e_is_x = sX[TILE + 2];
  int& sh_next = sX[TILE + 3];
  int* mend = sX + TILE + 4;                   // a re-walked segment's marks end here
  // The staged chunk: each position's hop, with the sign bit set where
  // the speculation marked it (hops are at most HOP_MAX < 2^31).
  int* cw = mend + TILE;
  int8_t* sst = reinterpret_cast<int8_t*>(cw + chunk);
  uint8_t* need = reinterpret_cast<uint8_t*>(sst + TILE);

  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int s = lane_start(start, lane, n);
  const int L = lane_end(length, lane, n);
  if (s >= L) return;
  const int32_t* step = step_all + (size_t)lane * n;
  uint8_t* marks = marks_all + (size_t)lane * n;
  const int32_t* Fl = F_all + (size_t)lane * nseg;
  const int32_t* Xl = X_all + (size_t)lane * nseg;
  int8_t* stl = status + (size_t)lane * nseg;

  const int jfirst = s / seg;       // EXACT: its speculation starts at s
  const int jlast = (L - 1) / seg;  // the last segment below L
  int E = Xl[jfirst];
  bool e_is_x = true;               // E = X of the segment below the next one
  int c_lo = 0, c_hi = 0;           // staged positions [c_lo, c_hi)

  for (int t0 = jfirst + 1; t0 <= jlast; t0 += TILE) {
    const int nt = min(TILE, jlast + 1 - t0);
    __syncthreads();
    for (int i = tid; i < nt; i += FIX_THREADS) {
      sF[i] = Fl[t0 + i];
      sX[i + 1] = Xl[t0 + i];
      sst[i] = stl[t0 + i];
    }
    if (tid == 0) sX[0] = Xl[t0 - 1];
    __syncthreads();
    for (int i = tid; i < nt; i += FIX_THREADS)
      need[i] = sst[i] == ST_SPECULATED && sF[i] != sX[i];
    __syncthreads();

    int cur = 0;  // tile index of the next segment to resolve
    while (cur < nt) {
      int i = cur;
      if (e_is_x) {
        // The next segment whose speculation misses X of the one below;
        // those between anchor. Every warp finds the same one.
        i = -1;
        for (int base = cur; base < nt && i < 0; base += 32) {
          const int k = base + (tid & 31);
          const unsigned hit = __ballot_sync(FULL, k < nt && need[k]);
          if (hit) i = base + __ffs(hit) - 1;
        }
        if (i < 0) {
          E = sX[nt];
          break;
        }
        E = sX[i];
      }
      if (sst[i] != ST_SPECULATED || sF[i] == E) {  // exact or anchored
        E = sX[i + 1];
        e_is_x = true;
        cur = i + 1;
        continue;
      }
      // A round: stage the chunk from segment i unless it is staged, then
      // one thread resolves segment i and those after it in the chunk.
      const int a = (t0 + i) * seg;
      __syncthreads();  // the last write-out has read cw, sst and mend
      if (min(a + seg, L) > c_hi) {
        c_lo = a;
        c_hi = min(a + chunk, L);
#pragma unroll 8
        for (int k = tid; k < c_hi - c_lo; k += FIX_THREADS)
          cw[k] = hop(step[c_lo + k]) | (marks[c_lo + k] ? (int)0x80000000 : 0);
        __syncthreads();
      }
      if (tid == 0) {
        int e = E, k = i;
        bool ex = e_is_x;
        for (; k < nt; ++k) {
          const int ak = (t0 + k) * seg;
          const int lk = min(ak + seg, L);
          if (lk > c_hi) break;
          if (sst[k] != ST_SPECULATED || sF[k] == e) {  // exact or anchored
            e = sX[k + 1];
            ex = true;
            continue;
          }
          // Walk the true chain from e until it lands on a speculative
          // mark (merged: the marks from there on stand) or leaves, and
          // mark its positions. Those are not speculative marks, so these
          // stores and the block's clearing below never meet.
          int p = e;
          int w = p < lk ? cw[p - c_lo] : 0;
          while (p < lk && w >= 0) {
            const int q = p + w;
            w = q < lk ? cw[q - c_lo] : 0;
            marks[p] = 1;
            p = q;
          }
          const bool merged = p < lk;
          mend[k] = merged ? p : lk;
          sst[k] = merged ? ST_RERUN : ST_UNMERGED;
          e = merged ? sX[k + 1] : p;
          ex = merged;
        }
        sh_E = e;
        sh_e_is_x = ex;
        sh_next = k;
      }
      __syncthreads();
      E = sh_E;
      e_is_x = sh_e_is_x;
      cur = sh_next;
      // Clear the speculation's marks below each re-walked segment's
      // merge point.
      const int x_end = min((t0 + cur) * seg, L);
      for (int x = a + tid; x < x_end; x += FIX_THREADS) {
        const int k = x / seg - t0;
        if (cw[x - c_lo] < 0 && (sst[k] == ST_RERUN || sst[k] == ST_UNMERGED) && x < mend[k])
          marks[x] = 0;
      }
    }
    __syncthreads();
    for (int k = tid; k < nt; k += FIX_THREADS)
      stl[t0 + k] = sst[k] == ST_SPECULATED ? ST_ANCHORED : sst[k];
  }
}

__host__ int fix_smem(int chunk) { return TILE * (4 + 4 + 4 + 1 + 1) + 16 + chunk * 4; }

}  // namespace

extern "C" int zt_chain(const void* step, const void* start, const void* length, void* marks,
                        void* fx, void* status, int B, int n, int seg, int warm, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  if (seg < 1 || warm < 0 || n >= HOP_MAX) return (int)cudaErrorInvalidValue;
  int T = SPEC_THREADS;
  while (T > 1 && spec_smem(T, seg, warm) > SMEM_MAX) --T;
  const int chunk = max(seg, (FIX_CHUNK / seg) * seg);
  if (spec_smem(T, seg, warm) > SMEM_MAX || fix_smem(chunk) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int nseg = (n + seg - 1) / seg;
  const int bpl = (nseg + T - 1) / T;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* s = (const int32_t*)step;
  const int32_t* a = (const int32_t*)start;
  const int32_t* l = (const int32_t*)length;
  uint8_t* m = (uint8_t*)marks;
  int32_t* F = (int32_t*)fx;
  int32_t* X = F + (size_t)B * nseg;
  int8_t* stat = (int8_t*)status;
  const int spec_bytes = spec_smem(T, seg, warm);
  const int fix_bytes = fix_smem(chunk);
  // Raise each kernel's shared memory limit once per device and size (a
  // host call that would otherwise cost every launch).
  static int spec_allowed[64], fix_allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (spec_bytes > spec_allowed[dev]) {
    err = cudaFuncSetAttribute(chain_spec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               spec_bytes);
    if (err != cudaSuccess) return (int)err;
    spec_allowed[dev] = spec_bytes;
  }
  if (fix_bytes > fix_allowed[dev]) {
    err = cudaFuncSetAttribute(chain_fixup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fix_bytes);
    if (err != cudaSuccess) return (int)err;
    fix_allowed[dev] = fix_bytes;
  }
  chain_spec_kernel<<<B * bpl, T, spec_bytes, st>>>(s, a, l, m, F, X, stat, n, nseg, seg, warm,
                                                    bpl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chain_fixup_kernel<<<B, FIX_THREADS, fix_bytes, st>>>(s, a, l, m, F, X, stat, n, nseg, seg,
                                                        chunk);
  return (int)cudaGetLastError();
}
