// Backward optimal-parse cost DP over a batch of block lanes.
//
// Replaces the TPU kernel zultra_tpu/ops/dp_pallas.py::_dp_kernel
// (reference semantics: zultra src/blockdeflate.c:254-323). At each
// position p, from the lane's end down to 0:
//   literal   lit[p] + cost[p+1]
//   shorts    per slot, the cheapest truncation k = 3..sc of a match
//             shorter than 40: one packed ((varlen_k + cost[p+k]) << 6 |
//             63-k) prefix minimum, so the largest k wins ties, plus the
//             slot's offset bits
//   longs     per slot, lcs + cost[p+clamped] (0 past the block end)
//   winner    the packed minimum of (cost*16 | candidate), candidates in
//             the reference's order: literal, then slots 0..7
// and writes chosen_len | slot << 9. The constants and packings are the
// TPU kernel's (dp_pallas.py:60-65, 105-150), so the choices agree bit
// for bit. cost[p] = 0 for p >= the lane's length (the lit there is 0, so
// the recurrence gives 0 from the padded end down to it): the kernel
// starts at the length and writes choice 0 past it.
//
// What bounds it on the card: cost[p] depends on cost[p+1..p+258], so a
// lane is one long serial chain of a few hundred integer operations per
// position; the inputs stream once (68 bytes a position). A lane run by
// one thread leaves the card idle.
//
// What this design does about it: it cuts the chain. Each lane is cut
// into segments [a, b) of `seg` positions, and three launches follow.
//   1. Speculate (one thread per segment, all lanes at once): run from a
//      zero cost ring at min(b + warm, length) down to a; keep the costs
//      and choices of [a, b) and the warm-up costs of [b, b + warm). A
//      segment whose run starts at the length starts from the true
//      boundary and is exact. The ring (the 259 live costs) and the
//      shorts' prefix minima sit in shared memory, [slot][thread].
//   2. Check (one thread per segment): a segment is anchored when its
//      warm-up costs and the next segment's costs differ by one constant
//      over 258 consecutive positions. Every candidate at p reads only
//      cost[p+1..p+258], so below such a run all candidates carry the
//      same constant, and the argmin and its tie-breaks are the same:
//      if the segment above is exact up to a constant, so is this one.
//   3. Fix up (one warp per lane, top down): re-run sequentially each
//      segment that is not anchored, from the ring the segment above
//      holds, and check the segment below against the new costs.
// The argument needs exact integer sums. A literal costs at most 15 bits
// and a length symbol 20, so on a lane of at most 2^21 positions (a 2 MiB
// block, the largest; ops/dp_cuda.py MAX_LANE) every cost is at most
// 15 * 2^21 and a packed short, (cost + 20) * 64 + 63, stays below 2^31;
// INF = 2^26 stays above every real candidate. The TPU kernel clamps its
// packed sums at 2^24 - 1, but runs only on blocks of up to 2^20
// positions, where no sum reaches that; longer blocks take the JAX
// package's scan DP, which has no clamp, as the reference has none. So
// this kernel has none either, and every lane runs the same schedule.
// A lane that never anchors (a long zero run, whose optimal parse is
// phase-locked to the run's end) costs one sequential pass plus 1-2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 1 << 26;
constexpr int INF16 = 0x7FFF;
constexpr int MAX_LANE = 1 << 21;
constexpr int MIN_MATCH = 3;
constexpr int LEAVE_ALONE = 40;
constexpr int NM = 8;
constexpr int NS = LEAVE_ALONE - MIN_MATCH;  // 37 truncation lengths
constexpr int TAPS = 258;                    // cost[p] reads cost[p+1 .. p+258]
constexpr int RING = TAPS + 1;               // slot of position q: q % RING
constexpr int SPEC_THREADS = 32;
constexpr int CHECK_THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Segment status (ops/dp_cuda.py ST_*).
constexpr int8_t ST_NONE = 0, ST_EXACT = 1, ST_ANCHORED = 2, ST_SPECULATED = 3, ST_RERUN = 4;

struct Lane {
  const int32_t* lit;
  const int4* p1;  // two int4 per position: the 8 slots
  const int4* p2;
  int32_t* out;
  int32_t* cost;
};

struct Pos {
  int lit;
  int4 a0, a1, b0, b1;
};

__device__ __forceinline__ Lane lane_at(const int32_t* lit, const int32_t* p1, const int32_t* p2,
                                        int32_t* out, int32_t* cost, int lane, int n) {
  const size_t base = (size_t)lane * n;
  return Lane{lit + base, reinterpret_cast<const int4*>(p1 + base * NM),
              reinterpret_cast<const int4*>(p2 + base * NM), out + base, cost + base};
}

__device__ __forceinline__ Pos load_pos(const Lane& ln, int p) {
  return Pos{__ldg(ln.lit + p), __ldg(ln.p1 + 2 * p), __ldg(ln.p1 + 2 * p + 1),
             __ldg(ln.p2 + 2 * p), __ldg(ln.p2 + 2 * p + 1)};
}

// One position of the recurrence: the costs of p+1..p+258 are in the
// ring (entry of slot i at ring[i * stride]), `slot` is p % RING. Writes
// cost[p] into the ring and returns the packed choice.
__device__ __forceinline__ int dp_step(const Pos& in, const int (&vl)[NS], int* ring, int* pm,
                                       int stride, int slot) {
  auto tap = [&](int k) {
    const int i = slot + k;
    return ring[(i >= RING ? i - RING : i) * stride];
  };
  const int a[NM] = {in.a0.x, in.a0.y, in.a0.z, in.a0.w, in.a1.x, in.a1.y, in.a1.z, in.a1.w};
  const int b[NM] = {in.b0.x, in.b0.y, in.b0.z, in.b0.w, in.b1.x, in.b1.y, in.b1.z, in.b1.w};
  // Every tap is read before the first store to pm: both sit in shared
  // memory, and a load the compiler cannot prove apart from a store
  // waits for it.
  int t[NS];
#pragma unroll
  for (int k = MIN_MATCH; k < LEAVE_ALONE; ++k) t[k - MIN_MATCH] = tap(k);
  const int next = tap(1);
  int fut[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int cl = b[m] >> 16;
    fut[m] = cl < LEAVE_ALONE ? 0 : tap(cl);
  }
  // Shorts: packed prefix minimum over k = 3..39.
  int run = 0x7FFFFFFF;
#pragma unroll
  for (int k = MIN_MATCH; k < LEAVE_ALONE; ++k) {
    const int x = vl[k - MIN_MATCH] + t[k - MIN_MATCH];
    run = min(run, x * 64 + (63 - k));
    pm[(k - MIN_MATCH) * stride] = run;
  }
  int key = (in.lit + next) * 16;
  int lsel = 0;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int sc = a[m] >> 16;
    const int osz = a[m] & 0xFFFF;
    const int wg = pm[max(sc - MIN_MATCH, 0) * stride];
    const int cand_s = sc >= MIN_MATCH ? (wg >> 6) + osz : INF;
    const int cl = b[m] >> 16;
    const int lcs = b[m] & 0xFFFF;
    const bool valid_l = lcs != INF16;
    const int cand_l = valid_l ? lcs + fut[m] : INF;
    const int cand = min(cand_s, cand_l);
    const int km = cand * 16 + m + 1;
    if (km < key) {
      key = km;
      lsel = valid_l ? cl : 63 - (wg & 63);
    }
  }
  const int mcode = key & 15;
  ring[slot * stride] = key >> 4;
  return (mcode > 0 ? lsel : 0) | (mcode << 9);
}

// The recurrence from hi-1 down to lo; the ring holds the costs of
// hi..hi+257. Costs and choices below `keep` go to the lane; costs at or
// above it (a speculated segment's warm-up) to warm[p - keep].
__device__ __forceinline__ void run_span(const Lane& ln, const int (&vl)[NS], int* ring, int* pm,
                                         int stride, int lo, int hi, int keep, int32_t* warm) {
  if (hi <= lo) return;
  int slot = (hi - 1) % RING;
  Pos cur = load_pos(ln, hi - 1);
  for (int p = hi - 1; p >= lo; --p) {
    const Pos nxt = load_pos(ln, max(p - 1, lo));  // in flight during the step
    const int v = dp_step(cur, vl, ring, pm, stride, slot);
    const int c = ring[slot * stride];
    if (p < keep) {
      ln.out[p] = v;
      ln.cost[p] = c;
    } else {
      warm[p - keep] = c;
    }
    cur = nxt;
    slot = slot == 0 ? RING - 1 : slot - 1;
  }
}

__device__ __forceinline__ void load_varlen(const int32_t* varlen40, int lane, int (&vl)[NS]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) vl[k] = __ldg(varlen40 + lane * 40 + k);
}

// The shift check: do the two cost runs differ by one constant over TAPS
// consecutive positions?
__device__ bool anchored(const int32_t* warm, const int32_t* cost, int len) {
  int run = 0, prev = 0;
  for (int i = 0; i < len; ++i) {
    const int d = warm[i] - cost[i];
    run = (i > 0 && d == prev) ? run + 1 : 1;
    prev = d;
    if (run >= TAPS) return true;
  }
  return false;
}

__device__ __forceinline__ int lane_length(const int32_t* length, int lane, int n) {
  return min(max(length[lane], 0), n);
}

// Launch 1: one thread per (lane, segment).
__global__ void __launch_bounds__(SPEC_THREADS)
    dp_spec_kernel(const int32_t* __restrict__ lit, const int32_t* __restrict__ p1,
                   const int32_t* __restrict__ p2, const int32_t* __restrict__ varlen40,
                   const int32_t* __restrict__ length, int32_t* __restrict__ out,
                   int32_t* __restrict__ cost, int32_t* __restrict__ warm,
                   int8_t* __restrict__ status, int B, int n, int nseg, int seg, int wlen,
                   int wstride) {
  __shared__ int s_ring[RING * SPEC_THREADS];
  __shared__ int s_pm[NS * SPEC_THREADS];
  const int g = blockIdx.x * SPEC_THREADS + threadIdx.x;
  if (g >= B * nseg) return;
  const int lane = g / nseg;
  const int L = lane_length(length, lane, n);
  const Lane ln = lane_at(lit, p1, p2, out, cost, lane, n);
  const int a = (g % nseg) * seg;
  const int b = min(a + seg, L);
  for (int p = max(a, L); p < min(a + seg, n); ++p) ln.out[p] = 0;
  if (a >= L) {
    status[g] = ST_NONE;
    return;
  }
  const int top = min(b + wlen, L);
  status[g] = top == L ? ST_EXACT : ST_SPECULATED;
  int vl[NS];
  load_varlen(varlen40, lane, vl);
  int* ring = s_ring + threadIdx.x;
  for (int i = 0; i < RING; ++i) ring[i * SPEC_THREADS] = 0;
  run_span(ln, vl, ring, s_pm + threadIdx.x, SPEC_THREADS, a, top, b, warm + (size_t)g * wstride);
}

// Launch 2: one thread per speculated segment.
__global__ void dp_check_kernel(const int32_t* __restrict__ cost, const int32_t* __restrict__ warm,
                                int8_t* __restrict__ status, int B, int n, int nseg, int seg,
                                int wlen, int wstride) {
  const int g = blockIdx.x * CHECK_THREADS + threadIdx.x;
  if (g >= B * nseg || status[g] != ST_SPECULATED) return;
  const int b = (g % nseg) * seg + seg;  // speculated: b + wlen < length
  if (anchored(warm + (size_t)g * wstride, cost + (size_t)(g / nseg) * n + b, wlen))
    status[g] = ST_ANCHORED;
}

// Launch 3: one warp per lane, top down. Lane 0 runs the sequential
// passes; the warp finds the next speculated segment and loads rings.
__global__ void __launch_bounds__(32)
    dp_fixup_kernel(const int32_t* __restrict__ lit, const int32_t* __restrict__ p1,
                    const int32_t* __restrict__ p2, const int32_t* __restrict__ varlen40,
                    const int32_t* __restrict__ length, int32_t* __restrict__ out,
                    int32_t* __restrict__ cost, const int32_t* __restrict__ warm,
                    int8_t* __restrict__ status, int n, int nseg, int seg, int wlen,
                    int wstride) {
  __shared__ int f_ring[RING];
  __shared__ int f_pm[NS];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = lane_length(length, lane, n);
  if (L <= 0) return;
  const Lane ln = lane_at(lit, p1, p2, out, cost, lane, n);
  int8_t* st = status + (size_t)lane * nseg;
  int vl[NS];
  load_varlen(varlen40, lane, vl);

  // Re-run [a, b) from the costs of b..b+257 (0 at and past the length).
  auto rerun = [&](int a, int b) {
    for (int q = b + tid; q < b + TAPS; q += 32) f_ring[q % RING] = q < L ? ln.cost[q] : 0;
    __syncwarp();
    if (tid == 0) run_span(ln, vl, f_ring, f_pm, 1, a, b, b, nullptr);
    __syncwarp();
  };

  bool above = false;  // the segment above was re-run
  for (int s = (L + seg - 1) / seg - 1; s >= 0; --s) {
    if (above) {
      int ok = 0;
      if (tid == 0) {
        const int b = s * seg + seg;
        ok = st[s] == ST_EXACT ||
             anchored(warm + ((size_t)lane * nseg + s) * wstride, ln.cost + b, wlen);
        if (ok && st[s] != ST_EXACT) st[s] = ST_ANCHORED;
      }
      if (__shfl_sync(FULL, ok, 0)) {
        above = false;
        continue;
      }
    } else {
      // The highest segment at or below s still speculated.
      int found = -1;
      for (int base = s; base >= 0 && found < 0; base -= 32) {
        const int i = base - tid;
        const unsigned hit = __ballot_sync(FULL, i >= 0 && st[i] == ST_SPECULATED);
        if (hit) found = base - (__ffs(hit) - 1);
      }
      if (found < 0) break;
      s = found;
    }
    const int a = s * seg;
    rerun(a, min(a + seg, L));
    if (tid == 0) st[s] = ST_RERUN;
    __syncwarp();
    above = true;
  }
}

}  // namespace

extern "C" int zt_dp(const void* lit, const void* p1, const void* p2, const void* varlen40,
                     const void* length, void* out, void* cost, void* warm, void* status, int B,
                     int n, int seg, int wlen, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  if (n > MAX_LANE) return (int)cudaErrorInvalidValue;  // the sums' int32 bound
  // A re-run's taps and a segment's check lie in the one segment above.
  if (seg < TAPS || wlen < 0 || wlen > seg) return (int)cudaErrorInvalidValue;
  const int nseg = (n + seg - 1) / seg;
  const int wstride = wlen > 0 ? wlen : 1;
  const int total = B * nseg;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* l = (const int32_t*)lit;
  const int32_t* a = (const int32_t*)p1;
  const int32_t* b = (const int32_t*)p2;
  const int32_t* v = (const int32_t*)varlen40;
  const int32_t* len = (const int32_t*)length;
  int32_t* o = (int32_t*)out;
  int32_t* c = (int32_t*)cost;
  int32_t* w = (int32_t*)warm;
  int8_t* s = (int8_t*)status;
  dp_spec_kernel<<<(total + SPEC_THREADS - 1) / SPEC_THREADS, SPEC_THREADS, 0, st>>>(
      l, a, b, v, len, o, c, w, s, B, n, nseg, seg, wlen, wstride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dp_check_kernel<<<(total + CHECK_THREADS - 1) / CHECK_THREADS, CHECK_THREADS, 0, st>>>(
      c, w, s, B, n, nseg, seg, wlen, wstride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dp_fixup_kernel<<<B, 32, 0, st>>>(l, a, b, v, len, o, c, w, s, n, nseg, seg, wlen, wstride);
  return (int)cudaGetLastError();
}
