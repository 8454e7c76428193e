// Moffat-Katajainen phases 1-2 and Kraft-sum length limiting for a batch
// of Huffman alphabets: one lane per alphabet, S <= 288 symbols.
//
// Replaces the TPU kernels zultra_tpu/ops/mk_pallas.py::_mk12_kernel (the
// in-place two-queue merge and parent-chain depths of reference
// src/huffman/huffencoder.c:157-270) and ::_kraft_kernel (the Kraft repair
// of :279-346). Callers: entropy_torch.mk_lengths and limited_lengths, from
// the block splitter's MK costs, every Huffman build of the block planner
// and the CL-mask search.
//
// What bounds them on the card: neither bytes nor arithmetic. Each lane is
// a dependent chain of about S steps (MK: a merge step of two picks, then
// the parent chain; Kraft: a carried Kraft sum through a lengthen and a
// shorten sweep), and most calls of the path have 1-84 lanes, so one
// lane's latency is the call: the copy in, the chain, the copy out.
//
// What the design does about it:
// - One copy round each way. A thread-per-lane MK block stages its rows, one
//   contiguous span, by one bulk asynchronous copy (TMA cp.async.bulk on
//   an mbarrier; the at most 3 words on either side of its 16-byte-aligned
//   interior by plain loads, so any 4-byte-aligned base works), transposes
//   them in shared memory to [symbol][lane] (every lane's data-dependent
//   index then falls in its own bank; the transposing reads run along a
//   diagonal, conflict-free at the path's S of 19, 32 and 288), and
//   writes its span back in 16-byte vectors. A warp-per-lane block moves
//   its row in one coalesced load and one coalesced store.
// - MK phase 1 runs on registers: the next two leaves and the next two
//   internal nodes are held, both picks of a step are one compare and
//   select, a new internal head is forwarded from the weight just made,
//   and the next step's reads are issued right after the step's stores
//   and used a step later (ops/mk_cuda.py states why every read sees the
//   value the in-place algorithm would). Four slots past each row repeat
//   its last, so no read needs a clamp.
// - MK phase 2 forwards the depth just computed where the parent is t + 1
//   and reads every other parent's depth two steps ahead; with a warp per
//   lane it is pointer jumping over the parent links (ceil(log2 depth)
//   rounds, S / 32 nodes a thread) where every updated node's parent lies
//   above it, which the warp checks.
// - Kraft, a warp per lane at every B: a lane whose Kraft sum is already
//   2^max_len is copied through registers and runs no sweep (72 of the 78
//   calls of a 4 MiB run have no other lane); one that does not fit runs
//   both sweeps on one thread, each fetching its next length ahead of
//   the carried sum, and phase B divides by a shift.
// - MK's layout follows the number of lanes B (ops/mk_cuda.py
//   WARP_LANES): a warp per lane for the planner's small batches, where
//   the card is otherwise idle, 32 lanes a warp for the splitter's
//   thousands.
// What still bounds them: MK phase 1, S - 1 merge steps of about 46
// instructions on one thread, most of them dependent (about 50 ns a step
// on an H100, PERF.md §6), and the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int MAX_S = 288;
constexpr int PER_THREAD = (MAX_S + LANES - 1) / LANES;  // row words a thread holds (warp layout)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int PAD = 4;  // slots past a row that repeat its last (MK phase 1's leaf reads)

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(max(x, 1)); }

__device__ __forceinline__ int clamp_idx(int i, int S) { return min(max(i, 0), S - 1); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory of a thread-per-lane block: an mbarrier, the [S + PAD][32]
// array, the staged span (32 * S words, up to 3 more for alignment).
__host__ __device__ __forceinline__ int lanes_smem(int S) {
  return 16 + (S + PAD) * LANES * 4 + ((LANES * S + 4) * 4 + 15) / 16 * 16;
}

// Stage the N words at g into shared memory -> a pointer p with
// p[i] == g[i], placed so that p and g agree mod 16 bytes. The aligned
// interior comes by one bulk copy completing on `bar`.
__device__ int32_t* stage_in(int32_t* sbuf, const int32_t* __restrict__ g, int N, uint64_t* bar) {
  const int tid = threadIdx.x;
  const int off = (int)(((uintptr_t)g >> 2) & 3);
  int32_t* p = sbuf + off;
  const int head = min(N, (4 - off) & 3);
  const int body = (N - head) & ~3;
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
        ::"r"(smem_addr(p + head)), "l"(g + head), "r"(bytes), "r"(smem_addr(bar)) : "memory");
  }
  for (int i = tid; i < head; i += blockDim.x) p[i] = g[i];
  for (int i = head + body + tid; i < N; i += blockDim.x) p[i] = g[i];
  if (bytes > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(bar)) : "memory");
    }
  }
  __syncthreads();
  return p;
}

// dst[i] = src[i] for i < N (src in shared memory): 16-byte vector
// stores on dst's aligned interior, vector reads where src is aligned too.
__device__ void copy_out(int32_t* __restrict__ dst, const int32_t* src, int N) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int head = min(N, (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2));
  const int body = (N - head) & ~3;
  for (int i = tid; i < head; i += nt) dst[i] = src[i];
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int32_t* s = src + head;
  if (((uintptr_t)s & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    for (int i = tid; i < body / 4; i += nt) d4[i] = s4[i];
  } else {
    for (int i = tid; i < body / 4; i += nt) {
      d4[i] = make_int4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    }
  }
  for (int i = head + body + tid; i < N; i += nt) dst[i] = src[i];
}

// Between the staged rows (row r at stg + r * S) and the [S][32] array.
// Thread r takes row r, symbol s = (k + r) mod S at step k for even S
// (banks r (S + 1) + k - S [s wrapped], distinct when 32 divides S) and
// s = k for odd S (banks r S + k, distinct): the staged side is
// conflict-free at S = 19, 32 and 288, and the array side always is
// (bank r).
template <bool IN>
__device__ void transpose(int32_t* a, int32_t* stg, int S, int nl) {
  const int r = threadIdx.x;
  if (r >= nl) return;
  int s = (S & 1) ? 0 : r % S;
  int32_t* row = stg + r * S;
#pragma unroll 4
  for (int k = 0; k < S; ++k) {
    if (IN) {
      a[s * LANES + r] = row[s];
    } else {
      row[s] = a[s * LANES + r];
    }
    s = s + 1 == S ? 0 : s + 1;
  }
}

// MK phase 1 on one lane's array a[i * ST] (ST: 32 in the [S][32] array,
// 1 in a row), whose slots S..S+3 hold copies of slot S - 1 (a leaf read
// past the row reads slot S - 1, as the reference's clamped index does).
// Node t's weight goes to slot t; a consumed node's slot becomes its
// parent's index + 1.
template <int ST>
__device__ void mk_phase1(int32_t* a, int n, int S) {
  const int steps = min(n - 1, S - 1);
  if (steps <= 0) return;
  int L = 0, I = 0;  // heads of the leaf and internal queues
  // Leaves L..L+3 and nodes I, I+1 (meaningful once made) in registers;
  // x2, x3 are slots I+2, I+3 as fetched after the last step's stores.
  // Leaf slots are never written, so l2, l3 are simply fetched afresh.
  int l0 = a[0], l1 = a[ST], l2 = a[2 * ST], l3 = a[3 * ST];
  int i0 = 0, i1 = 0, x2 = 0, x3 = 0;
  for (int t = 0; t < steps; ++t) {
    const int left = n - L;  // leaves not yet taken
    const bool first_int = left <= 0 || (I < t && i0 < l0);
    const bool second_int = first_int ? (left <= 0 || (I + 1 < t && i1 < l0))
                                      : (left <= 1 || (I < t && i0 < l1));
    const bool two_int = first_int && second_int, two_leaves = !first_int && !second_int;
    // Two internal nodes: i0 + i1; one of each: i0 + l0; two leaves.
    const int w = (int)(two_int ? (unsigned)i0 + (unsigned)i1
                                : (two_leaves ? (unsigned)l0 + (unsigned)l1
                                              : (unsigned)i0 + (unsigned)l0));
    // Nodes I..I+3, node t being w (made this step, not yet stored).
    const int c0 = I == t ? w : i0;
    const int c1 = I + 1 == t ? w : i1;
    const int c2 = I + 2 == t ? w : x2;
    const int c3 = I + 3 == t ? w : x3;
    i0 = two_int ? c2 : (two_leaves ? c0 : c1);
    i1 = two_int ? c3 : (two_leaves ? c1 : c2);
    const int n0 = two_int ? l0 : (two_leaves ? l2 : l1);
    l1 = two_int ? l1 : (two_leaves ? l3 : l2);
    l0 = n0;
    if (!two_leaves) a[I * ST] = t + 1;
    if (two_int) a[(I + 1) * ST] = t + 1;
    a[t * ST] = w;
    const int m = two_int ? 2 : (two_leaves ? 0 : 1);  // internal nodes taken
    I += m;
    L += 2 - m;
    // The next step's fetches, after this step's stores: no leaf slot is
    // ever written, and a node made at step t is read from slot t.
    const int Lc = min(L, S - 1);
    l2 = a[(Lc + 2) * ST];
    l3 = a[(Lc + 3) * ST];
    x2 = a[(I + 2) * ST];
    x3 = a[(I + 3) * ST];
  }
}

// MK phase 2, serial: the root, then a[t] = a[parent(t)] + 1 from
// t = min(S, n) - 3 down, with the parent's depth forwarded when the
// parent is t + 1 and otherwise read a step ahead.
template <int ST>
__device__ void mk_phase2_serial(int32_t* a, int n, int S) {
  const int tmax = min(S - 3, n - 3);
  if (tmax < 0) return;
  auto slot = [&](int t) { return t >= 0 ? a[t * ST] : 0; };
  // Node t's parent p0 and the depth read for it pv0, node t - 1's (p1,
  // pv1), the slots of nodes t - 2 and t - 3 (c2, c3). Each read is
  // issued two steps before its use, after the step's store: only the
  // depth of node t + 1, stored since, is forwarded.
  int p0 = clamp_idx(slot(tmax) - 1, S), pv0 = a[p0 * ST];
  int p1 = clamp_idx(slot(tmax - 1) - 1, S), pv1 = tmax >= 1 ? a[p1 * ST] : 0;
  int c2 = slot(tmax - 2), c3 = slot(tmax - 3);
  int d_prev = 0;
  for (int t = tmax; t >= 0; --t) {
    const int d = (p0 == t + 1 && t + 1 <= tmax ? d_prev : pv0) + 1;
    a[t * ST] = d;
    d_prev = d;
    const int p2 = clamp_idx(c2 - 1, S);
    const int pv2 = t >= 2 ? a[p2 * ST] : 0;
    c2 = c3;
    c3 = slot(t - 4);
    p0 = p1;
    pv0 = pv1;
    p1 = p2;
    pv1 = pv2;
  }
}

// MK phase 2 by one warp for one lane in a row a[0..S): pointer jumping
// where every updated node's parent lies above it, else the serial sweep.
__device__ void mk_phase2_warp(int32_t* a, int32_t* P, int32_t* D, int n, int S) {
  const int tmax = min(S - 3, n - 3);
  if (tmax < 0) return;
  const int l = threadIdx.x;
  int ptr[PER_THREAD], d[PER_THREAD];
  bool above = true;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int t = l + LANES * k;
    ptr[k] = t <= tmax ? clamp_idx(a[t] - 1, S) : MAX_S;
    d[k] = 1;
    above &= t > tmax || ptr[k] > t;
  }
  if (!__all_sync(FULL, above)) {
    if (l == 0) mk_phase2_serial<1>(a, n, S);
    __syncwarp();
    return;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int t = l + LANES * k;
    if (t <= tmax) {
      P[t] = ptr[k];
      D[t] = 1;
    }
  }
  __syncwarp();
  while (true) {
    bool live = false;
    int np[PER_THREAD], nd[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      np[k] = ptr[k];
      nd[k] = d[k];
      if (ptr[k] <= tmax) {
        nd[k] = d[k] + D[ptr[k]];
        np[k] = P[ptr[k]];
        live = true;
      }
    }
    if (!__any_sync(FULL, live)) break;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int t = l + LANES * k;
      ptr[k] = np[k];
      d[k] = nd[k];
      if (t <= tmax) {
        P[t] = ptr[k];
        D[t] = d[k];
      }
    }
    __syncwarp();
  }
  // Every pointer now ends above tmax, where phase 2 writes nothing.
  int v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) v[k] = l + LANES * k <= tmax ? a[ptr[k]] : 0;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int t = l + LANES * k;
    if (t <= tmax) a[t] = (int)((unsigned)d[k] + (unsigned)v[k]);
  }
  __syncwarp();
}

// The Kraft repair of one lane that does not fit, on its row a.
__device__ void kraft_sweeps(int32_t* a, int n, int kraft, int max_len) {
  const int full = 1 << max_len;
  // Phase A: lengthen the rarest (descending position) while the sum
  // is over; once it fits no later step changes anything.
  if (kraft > full && n > 0) {
    int v = a[n - 1];
    for (int p = n - 1; p >= 0 && kraft > full; --p) {
      const int v_next = p > 0 ? a[p - 1] : 0;
      if (v < max_len) {
        const int r = (full >> v) - (kraft - full);
        const int v_new = min(r <= 0 ? max_len : max(v, max_len - floor_log2(r)), max_len);
        kraft += (full >> v_new) - (full >> v);
        a[p] = v_new;
      }
      v = v_next;
    }
  }
  // Phase B: re-shorten the most frequent (ascending position) while
  // room remains; the sum never decreases, so a full sum ends it. With
  // u = full >> len = 2^(max_len - len), m / u is a shift.
  if (kraft < full && n > 0) {
    int v = a[0];
    for (int p = 0; p < n && kraft < full; ++p) {
      const int v_next = p + 1 < n ? a[p + 1] : 0;
      const int m = (full - kraft) >> (max_len - min(max(v, 0), max_len));
      const int d = min(floor_log2(m + 1), max(v - 1, 0));
      kraft += (full >> v) * ((1 << d) - 1);
      a[p] = v - d;
      v = v_next;
    }
  }
}

// Thread-per-lane layout: 32 lanes a block, one warp.
__global__ void __launch_bounds__(LANES)
    mk12_lanes_kernel(const int32_t* __restrict__ a0, const int32_t* __restrict__ n_used,
                      int32_t* __restrict__ out, int B, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* a = reinterpret_cast<int32_t*>(smem + 16);
  const int lane0 = blockIdx.x * LANES;
  const int nl = min(LANES, B - lane0);
  const int l = threadIdx.x;
  const int n = l < nl ? n_used[lane0 + l] : 0;
  int32_t* stg = stage_in(a + (S + PAD) * LANES, a0 + (size_t)lane0 * S, nl * S, bar);
  transpose<true>(a, stg, S, nl);
  if (l < nl) {
    for (int j = 0; j < PAD; ++j) a[(S + j) * LANES + l] = a[(S - 1) * LANES + l];
  }
  __syncthreads();
  if (l < nl) {
    mk_phase1<LANES>(a + l, n, S);
    a[clamp_idx(n - 2, S) * LANES + l] = 0;  // the root, written for every lane
    mk_phase2_serial<LANES>(a + l, n, S);
  }
  __syncthreads();
  transpose<false>(a, stg, S, nl);
  __syncthreads();
  copy_out(out + (size_t)lane0 * S, stg, nl * S);
}

// Warp-per-lane layout: one lane a block.
__global__ void __launch_bounds__(LANES)
    mk12_warp_kernel(const int32_t* __restrict__ a0, const int32_t* __restrict__ n_used,
                     int32_t* __restrict__ out, int S) {
  __shared__ int32_t a[MAX_S + PAD], P[MAX_S], D[MAX_S];
  const size_t base = (size_t)blockIdx.x * S;
  const int l = threadIdx.x;
  int v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = l + LANES * k;
    v[k] = i < S ? a0[base + i] : 0;
  }
  const int n = n_used[blockIdx.x];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    if (l + LANES * k < S) a[l + LANES * k] = v[k];
  }
  __syncwarp();
  if (l < PAD) a[S + l] = a[S - 1];
  __syncwarp();
  if (l == 0) {
    mk_phase1<1>(a, n, S);
    a[clamp_idx(n - 2, S)] = 0;
  }
  __syncwarp();
  mk_phase2_warp(a, P, D, n, S);
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = l + LANES * k;
    if (i < S) out[base + i] = a[i];
  }
}

__global__ void __launch_bounds__(LANES)
    kraft_warp_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ n_used,
                      const int32_t* __restrict__ kraft0, int32_t* __restrict__ out, int S,
                      int max_len) {
  __shared__ int32_t a[MAX_S];
  const size_t base = (size_t)blockIdx.x * S;
  const int l = threadIdx.x;
  int v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = l + LANES * k;
    v[k] = i < S ? lens[base + i] : 0;
  }
  const int kraft = kraft0[blockIdx.x];
  if (kraft != (1 << max_len)) {
    const int n = min(n_used[blockIdx.x], S);
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (l + LANES * k < S) a[l + LANES * k] = v[k];
    }
    __syncwarp();
    if (l == 0) kraft_sweeps(a, n, kraft, max_len);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (l + LANES * k < S) v[k] = a[l + LANES * k];
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = l + LANES * k;
    if (i < S) out[base + i] = v[k];
  }
}

// The thread-per-lane kernel's shared memory limit, raised once per device
// (an attribute is a device's, and the host call would otherwise cost
// every launch; the eager run before a graph capture sets it, so no
// capture meets the call).
constexpr int MAX_DEVICES = 64;
bool mk12_smem_set[MAX_DEVICES];

cudaError_t allow_lanes_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (mk12_smem_set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mk12_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             lanes_smem(MAX_S));
  if (err == cudaSuccess) mk12_smem_set[dev] = true;
  return err;
}

}  // namespace

extern "C" int zt_mk12(const void* a0, const void* n_used, void* out, int B, int S,
                       int warp_per_lane, void* stream) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (warp_per_lane) {
      mk12_warp_kernel<<<B, LANES, 0, st>>>((const int32_t*)a0, (const int32_t*)n_used,
                                            (int32_t*)out, S);
    } else {
      const cudaError_t err = allow_lanes_smem();
      if (err != cudaSuccess) return (int)err;
      mk12_lanes_kernel<<<(B + LANES - 1) / LANES, LANES, lanes_smem(S), st>>>(
          (const int32_t*)a0, (const int32_t*)n_used, (int32_t*)out, B, S);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int zt_kraft(const void* lens, const void* n_used, const void* kraft0, void* out,
                        int B, int S, int max_len, void* stream) {
  if (S < 1 || S > MAX_S || max_len < 1 || max_len > 15) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    kraft_warp_kernel<<<B, LANES, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lens, (const int32_t*)n_used, (const int32_t*)kraft0, (int32_t*)out, S,
        max_len);
  }
  return (int)cudaGetLastError();
}
