// The block planner's fused per-position passes, four kernels:
//
// - prep_lanes (K11): the DP's packed statics for every (lane, position,
//   match slot): lit, p1, p2 and the lane's varlen40. Replaces the fused
//   XLA body of zultra_tpu/ops/dp_pallas.py::_prep_lane (vmapped in
//   run_dp_pallas); caller ops/dp_cuda.py::prep_lanes, once a DP call.
// - token_hist (K12): the literal/length and offset symbol histograms of
//   a lane's tokens, EOD += 1 (zultra_tpu/ops/block_jax.py::_token_hist,
//   its scatter form); caller ops/block_torch.py::token_hist.
// - emit_tokens (K13): every token's codeword and extra bits packed
//   LSB-first into 64-bit words holding 32-bit values, EOD last, and the
//   total bits (block_jax.py::_emit_tokens); caller
//   ops/block_torch.py::emit_tokens.
// - lex_order (K14): the indices that sort each row of int32 keys by
//   (key, index), the order of lax.sort((key, iota), num_keys=2) in
//   zultra_tpu/ops/entropy_jax.py (mk_lengths :77, limited_lengths :343,
//   canonical_codewords :449); caller ops/entropy_torch.py::_lex_order.
//
// No Pallas counterparts: in the JAX package these are XLA fusions inside
// the jitted planner (_plan_block_core). Every launch runs on the caller's
// stream, allocates nothing and never waits on the host, so the planner's
// CUDA graph records it. ops/plan_cuda.py holds the wrappers and the
// plain models of the schedules.
//
// What bounds them on the card: the bytes. prep_lanes reads 65 B a
// position (window byte, 8 match lengths and offsets) and writes 68 (lit,
// p1, p2); token_hist reads 10 B a position (of a strided view, a 32-byte
// sector for each marked position's length and each match's offset);
// emit_tokens reads 10 and writes half an 8-byte word; lex_order reads 4 B
// and writes 8 a key. At the planner's small shapes the chain of
// dependent steps bounds them instead: a launch of token_hist on 1 x
// 131072 positions or of lex_order on one row of 288 keys has well under a
// microsecond of bytes. On the splitter's 4096 rows of 288 keys lex_order
// is bound by its integer work: 45 stages of 256 64-bit compare-exchanges
// a row, some 3000 instructions a warp.
//
// What the design does about it:
// - prep_lanes: a block per (lane, tile of TILE positions); the lane's
//   two code-length tables in shared memory; a thread per (position,
//   slot) element, so each warp reads and writes 128 contiguous bytes of
//   the (B, n, 8) arrays. The symbol maps are closed forms of
//   floor(log2(x)) = 31 - clz(x).
// - token_hist: a block per (lane, tile of 1024 positions: 4 warps). A
//   warp takes
//   256 positions: each lane loads the marks and window bytes of its run
//   of RUN = 8 positions with one 8-byte load each, then the warp walks
//   the 256 positions 32 at a time (lane l at step e takes position 32 e
//   + l, its mark and byte shuffled from the run's lane), so each length
//   or offset load reads 32 neighbouring positions. All of a lane's length
//   loads (and, for contiguous rows, its offset loads) are issued before
//   any of them is used; a warp whose 32 runs are unmarked loads nothing
//   more. Each token adds one to the block's shared bins, and the block
//   adds its nonzero bins into the lane's rows with integer atomics
//   (exact in any order); block 0 of a lane adds the EOD. The rows are
//   made zero by the wrapper.
// - emit_tokens: one launch, a block per tile of EMIT_TILE (2048)
//   positions of a lane, 8 a thread, so that each position is read and
//   decoded once, a thread's loads are wide and all in flight together,
//   and each word is stored whole rather than added into piece by piece
//   (a token is 8-28 bits, so neighbouring threads' pieces meet in one
//   word and global atomics on it serialise). A block takes its tile from
//   an atomic ticket (lane-major, so a tile waits only on tiles whose
//   blocks are already resident); a thread loads its 8 positions at once
//   (one 8-byte load of bytes and of marks, two 16-byte loads of lengths
//   and of offsets) and computes each field once; one block scan gives
//   each thread its first bit in the tile; the tile publishes its bit count
//   at once and one warp finds the tile's first bit in the lane by a
//   decoupled look-back over the lane's tiles (64-bit status words, flag
//   and count: the tile's own bits, or the lane's bits to its end), exact
//   in any order of completion, while the other warps OR the fields into
//   the tile's words in shared memory (a shared atomic only on a thread's
//   first and last word). The tile then stores its words whole,
//   coalesced, shifted to the lane's bit alignment by a funnel shift; only
//   its first and last words, which a neighbouring tile or the EOD may
//   share, take a global atomicOr. The lane's last tile writes the total
//   and the EOD field. The words, the status words and the ticket are one
//   buffer that the C entry zeroes (one memset a call, on the stream), so
//   the words past the lane's total are zero. A field's value fits its bits (codes below
//   2^length, DEFLATE's extra bits), so OR equals the plain form's adds.
// - lex_order: for S <= 32 a warp a row ranks by count (the keys in
//   registers, read back by shuffles): key i goes to #{j: k_j < k_i} +
//   #{j < i: k_j == k_i}. Above 32, a bitonic sorting network on unique
//   64-bit words, (key ^ 2^31) << 32 | index, which sort in (key, index)
//   order, so any correct sort of them is the stable order; a row is
//   padded to P = 2^ceil(log2 S) words with ~0, which sort after every
//   key. Every comparator is ascending (each merge starts against the
//   mirror position), so no stage selects a direction. T = P / E threads
//   take a row, E words each, position i = t E + e (word e of thread t;
//   the keys are loaded as index e T + t, coalesced, since any start
//   order sorts). A stage runs in registers when the partner is in the
//   thread, by shuffles when it is in the warp, and through shared memory
//   with a barrier above that. Two layouts: at every width the latency
//   one, E = 2 (4 at P = 1024) and a row a block (the shortest chain, the
//   most threads a row), for the planner's few rows; at P = 512, the
//   width of the 288 keys that the planner and the splitter sort, the
//   throughput one from LEX_THROUGHPUT_ROWS rows, E = 16 and 8 rows a
//   block (the fewest shuffles, the grid over every SM), for the
//   splitter's thousands. The sorted indices pass through shared memory so
//   that each store writes contiguous indices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;  // positions a block of prep_lanes
constexpr int SLOTS = 8;    // match slots a position
constexpr int NLIT = 288;   // literal/length symbols
constexpr int NOFF = 32;    // offset symbols
constexpr int EOD = 256;    // end-of-block symbol
constexpr int MIN_MATCH = 3;
constexpr int LEAVE_ALONE = 40;  // matches of this length or more are never truncated
constexpr int N_SHORT = LEAVE_ALONE - MIN_MATCH;
constexpr int INF16 = 0x7FFF;
constexpr int BIG = 1 << 30;
constexpr int MAX_SORT = 1024;  // keys a lex_order row
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(x); }  // x >= 1

// (symbol, extra bits, base) of an encoded match length e = len - 3 in
// 0..255 (ops/symbol_map.py::matchlen_sym_extra_base).
__device__ __forceinline__ void len_symbol(int e, int& sym, int& extra, int& base) {
  const int k = max(floor_log2(max(e, 1)), 2);
  const int q = e >> (k - 2);
  if (e < 8) {
    sym = 257 + e, extra = 0, base = e;
  } else if (e == 255) {
    sym = 285, extra = 0, base = 255;
  } else {
    sym = 249 + 4 * k + q, extra = k - 2, base = q << (k - 2);
  }
}

// The two-level offset-table index of a match offset (symbol_map.py::
// offset_index).
__device__ __forceinline__ int offset_index(int off) {
  const int raw = max(off - 1, 0);
  const int oidx = raw < 256 ? raw : 256 + ((raw - 256) >> 7);
  return min(max(oidx, 0), 511);
}

// (symbol, extra bits, base) of an offset index (symbol_map.py::
// offset_sym_extra_base).
__device__ __forceinline__ void off_symbol(int oidx, int& sym, int& extra, int& base) {
  const int j = oidx < 256 ? oidx : ((oidx - 256) << 7) + 256;
  const int k = max(floor_log2(max(j, 1)), 1);
  const int bit = (j >> (k - 1)) & 1;
  if (j < 4) {
    sym = j, extra = 0, base = j + 1;
  } else {
    sym = 2 * k + bit, extra = k - 1, base = ((2 + bit) << (k - 1)) + 1;
  }
}

__device__ __forceinline__ int32_t pack16(int hi, int lo) {
  return (int32_t)(((uint32_t)hi << 16) | (uint32_t)lo);
}

// ---------------------------------------------------------------------------
// K11: the DP's lane preparation
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    prep_lanes_kernel(const int32_t* __restrict__ ll, const int32_t* __restrict__ ol,
                      const uint8_t* __restrict__ window, const int32_t* __restrict__ mlens,
                      const int32_t* __restrict__ moffs, const int32_t* __restrict__ length,
                      int32_t* __restrict__ lit, int32_t* __restrict__ p1,
                      int32_t* __restrict__ p2, int32_t* __restrict__ varlen40, int n) {
  __shared__ int s_ll[NLIT];
  __shared__ int s_ol[NOFF];
  const int b = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i < NLIT; i += THREADS) s_ll[i] = ll[(size_t)b * NLIT + i];
  if (tid < NOFF) s_ol[tid] = ol[(size_t)b * NOFF + tid];
  __syncthreads();
  const int len = length[b];
  const int p0 = blockIdx.x * TILE;
  const int p_end = min(p0 + TILE, n);

  if (blockIdx.x == 0 && tid < 40) {
    int v = BIG;
    if (tid < N_SHORT) {
      int sym, extra, base;
      len_symbol(tid, sym, extra, base);
      v = s_ll[sym] + extra;
    }
    varlen40[(size_t)b * 40 + tid] = v;
  }
  for (int p = p0 + tid; p < p_end; p += THREADS) {
    lit[(size_t)b * n + p] = p < len ? s_ll[window[(size_t)b * n + p]] : 0;
  }
  const size_t row = (size_t)b * n * SLOTS;
  const int e_end = (p_end - p0) * SLOTS;
  for (int e = tid; e < e_end; e += THREADS) {
    const size_t at = row + (size_t)p0 * SLOTS + e;
    const int p = p0 + e / SLOTS;
    const int ml = mlens[at];
    const int remaining = max(len - p, 0);
    const int clamped = min(ml, remaining);
    int osym, oextra, obase;
    off_symbol(offset_index(moffs[at]), osym, oextra, obase);
    const int osize = ((unsigned)osym < 30u ? s_ol[osym] : 0) + oextra;
    const bool valid = ml >= MIN_MATCH;
    const bool is_long = valid && ml >= LEAVE_ALONE;
    const bool is_short = valid && ml < LEAVE_ALONE;
    p1[at] = pack16(is_short ? clamped : 0, is_short ? osize : INF16);
    int e_raw = clamped - MIN_MATCH;
    if (e_raw < 0 || e_raw > 255) e_raw = 255;
    int lsym, lextra, lbase;
    len_symbol(e_raw, lsym, lextra, lbase);
    const int varlen_e = (lsym >= 257 && lsym < 286 ? s_ll[lsym] : 0) + lextra;
    p2[at] = pack16(is_long ? clamped : 0, is_long ? varlen_e + osize : INF16);
  }
}

// ---------------------------------------------------------------------------
// K12: token histograms
// ---------------------------------------------------------------------------

constexpr int RUN = 8;                       // positions of a lane's wide loads
constexpr int WARP_SPAN = 32 * RUN;          // positions a warp takes
constexpr int HIST_TILE = 1024;              // positions a block
constexpr int HIST_THREADS = HIST_TILE / RUN;  // 4 warps

// The nonzero bytes of a word of four marks, as 4 bits.
__device__ __forceinline__ unsigned byte_marks(unsigned x) {
  const unsigned ne = __vcmpne4(x, 0u);  // 0xFF where a byte is nonzero
  return (ne & 1u) | ((ne >> 7) & 2u) | ((ne >> 14) & 4u) | ((ne >> 21) & 8u);
}

// WIDE: n % RUN == 0 and the marks and window rows 8-byte aligned, so a
// lane's run is one 8-byte load of each. EAGER: the offsets are
// contiguous along the positions, so every marked position's offset is
// loaded beside its length (its sector is read anyway); else only a
// match's offset is loaded, after its length.
template <bool WIDE, bool EAGER>
__global__ void __launch_bounds__(HIST_THREADS)
    token_hist_kernel(const uint8_t* __restrict__ window, const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ offs, const uint8_t* __restrict__ is_tok,
                      int32_t* __restrict__ lit_hist, int32_t* __restrict__ off_hist, int n,
                      long long lens_lane, long long lens_pos, long long offs_lane,
                      long long offs_pos) {
  __shared__ int h_lit[NLIT];
  __shared__ int h_off[NOFF];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < NLIT; i += HIST_THREADS) h_lit[i] = 0;
  if (tid < NOFF) h_off[tid] = 0;
  __syncthreads();
  if (blockIdx.x == 0 && tid == 0) h_lit[EOD] = 1;
  const size_t row = (size_t)b * n;
  const int w0 = blockIdx.x * HIST_TILE + (tid >> 5) * WARP_SPAN;  // the warp's first
  const int p_run = w0 + lane * RUN;                                      // this lane's run
  unsigned marks = 0, w_lo = 0, w_hi = 0;  // bit i: position p_run + i is a token
  if (WIDE) {
    if (p_run < n) {
      const uint2 m = *reinterpret_cast<const uint2*>(is_tok + row + p_run);
      const uint2 w = *reinterpret_cast<const uint2*>(window + row + p_run);
      marks = byte_marks(m.x) | (byte_marks(m.y) << 4);
      w_lo = w.x, w_hi = w.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const int p = p_run + i;
      if (p < n && is_tok[row + p]) {
        marks |= 1u << i;
        const unsigned byte = window[row + p];
        if (i < 4) w_lo |= byte << (8 * i); else w_hi |= byte << (8 * (i - 4));
      }
    }
  }
  if (__any_sync(FULL, marks != 0)) {
    // Step e: lane l takes position w0 + 32 e + l, bit l % RUN of the run
    // of lane 4 e + l / RUN.
    int ml[RUN], of[RUN], byte[RUN];
    unsigned tok = 0;
#pragma unroll
    for (int e = 0; e < RUN; ++e) {
      const int src = e * (32 / RUN) + lane / RUN, bit = lane % RUN;
      const unsigned m = __shfl_sync(FULL, marks, src);
      const unsigned lo = __shfl_sync(FULL, w_lo, src), hi = __shfl_sync(FULL, w_hi, src);
      const bool t = (m >> bit) & 1u;
      tok |= (unsigned)t << e;
      byte[e] = ((bit < 4 ? lo : hi) >> (8 * (bit & 3))) & 0xFF;
      const long long p = w0 + 32 * e + lane;
      ml[e] = t ? lens[b * lens_lane + p * lens_pos] : 0;
      of[e] = (EAGER && t) ? offs[b * offs_lane + p * offs_pos] : 0;
    }
    if (!EAGER) {
#pragma unroll
      for (int e = 0; e < RUN; ++e) {
        const long long p = w0 + 32 * e + lane;
        if (((tok >> e) & 1u) && ml[e] >= MIN_MATCH) of[e] = offs[b * offs_lane + p * offs_pos];
      }
    }
#pragma unroll
    for (int e = 0; e < RUN; ++e) {
      if (!((tok >> e) & 1u)) continue;
      if (ml[e] >= MIN_MATCH) {
        int sym, extra, base;
        len_symbol(min(ml[e] - MIN_MATCH, 255), sym, extra, base);
        atomicAdd(&h_lit[sym], 1);
        off_symbol(offset_index(of[e]), sym, extra, base);
        atomicAdd(&h_off[sym], 1);
      } else {
        atomicAdd(&h_lit[byte[e]], 1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < NLIT; i += HIST_THREADS) {
    if (h_lit[i]) atomicAdd(&lit_hist[(size_t)b * NLIT + i], h_lit[i]);
  }
  if (tid < NOFF && h_off[tid]) atomicAdd(&off_hist[(size_t)b * NOFF + tid], h_off[tid]);
}

// ---------------------------------------------------------------------------
// K13: token emission
// ---------------------------------------------------------------------------

constexpr int EMIT_THREADS = THREADS;
constexpr int EMIT_PER = 8;                         // positions a thread
constexpr int EMIT_TILE = EMIT_THREADS * EMIT_PER;  // positions a block
// A position's two fields hold at most 48 bits (codes of at most 15 bits,
// extra bits of at most 5 and 13), so a tile's bits fit EMIT_WORDS words.
constexpr int FIELD_BITS = 48;
constexpr int EMIT_WORDS = EMIT_TILE * FIELD_BITS / 32 + 1;
// A tile's status word: the flag in the top two bits, a bit count below.
constexpr unsigned long long ST_AGGREGATE = 1ull << 62;  // the tile's own bits
constexpr unsigned long long ST_PREFIX = 2ull << 62;     // the lane's bits to the tile's end
constexpr unsigned long long ST_VALUE = (1ull << 62) - 1;

struct Codes {
  int lit_cw[NLIT], lit_len[NLIT], off_cw[NOFF], off_len[NOFF];
};

__device__ void load_codes(Codes& c, const int32_t* lit_cw, const int32_t* lit_len,
                           const int32_t* off_cw, const int32_t* off_len, int b) {
  for (int i = threadIdx.x; i < NLIT; i += blockDim.x) {
    c.lit_cw[i] = lit_cw[(size_t)b * NLIT + i];
    c.lit_len[i] = lit_len[(size_t)b * NLIT + i];
  }
  for (int i = threadIdx.x; i < NOFF; i += blockDim.x) {
    c.off_cw[i] = off_cw[(size_t)b * NOFF + i];
    c.off_len[i] = off_len[(size_t)b * NOFF + i];
  }
}

// The two fields of position p: (value, bits) of the literal or the
// length code with its extra bits, and of the offset code with its extra
// bits (0 bits where the position is no token or a literal).
struct Fields {
  long long v1, v2;
  int n1, n2;
};

__device__ __forceinline__ Fields position_fields(const Codes& c, int tok, int best_len,
                                                  int best_off, int byte) {
  Fields f = {0, 0, 0, 0};
  if (!tok) return f;
  if (best_len >= MIN_MATCH) {
    const int e = min(best_len - MIN_MATCH, 255);
    int ls, le, lb, os, oe, ob;
    len_symbol(e, ls, le, lb);
    off_symbol(offset_index(best_off), os, oe, ob);
    const bool l_in = ls >= 257 && ls < 286, o_in = (unsigned)os < 30u;
    const int ls_len = l_in ? c.lit_len[ls] : 0;
    const int os_len = o_in ? c.off_len[os] : 0;
    f.v1 = (long long)(l_in ? c.lit_cw[ls] : 0) |
           (long long)((unsigned long long)(long long)(e - lb) << ls_len);
    f.n1 = ls_len + le;
    f.v2 = (long long)(o_in ? c.off_cw[os] : 0) |
           (long long)((unsigned long long)(long long)(best_off - ob) << os_len);
    f.n2 = os_len + oe;
  } else {
    f.v1 = c.lit_cw[byte];
    f.n1 = c.lit_len[byte];
  }
  return f;
}

// Block-wide inclusive scan of one int a thread (THREADS threads); also
// returns the block's total through `total`.
__device__ __forceinline__ int block_scan(int x, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  return x + before;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The lane's bits before its tile j >= 1 (`row`: the lane's status words),
// by one warp: in each round lane l reads tile k - l, the warp waits until
// all 32 have published, then sums back to the nearest prefix; without
// one, the next round starts 32 tiles further back. Tile 0 publishes its
// prefix at once, so the walk ends there at the latest.
__device__ __forceinline__ long long look_back(const unsigned long long* row, int j) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (int k = j - 1;; k -= 32) {
    const int at = k - lane;
    unsigned long long st = at >= 0 ? load_status(row + at) : ST_PREFIX;
    while (__any_sync(FULL, (st >> 62) == 0)) {
      if ((st >> 62) == 0) st = load_status(row + at);
    }
    const unsigned prefix = __ballot_sync(FULL, (st >> 62) == 2);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    long long v = lane <= stop ? (long long)(st & ST_VALUE) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    before += v;
    if (prefix) return before;
  }
}

// OR the low 32 bits of `v` into the 64-bit word, where it holds any.
__device__ __forceinline__ void or_word(unsigned long long* w, unsigned long long v) {
  if (v & 0xFFFFFFFFull) atomicOr(w, v & 0xFFFFFFFFull);
}

// One launch a call. A block takes the tile its ticket names (tickets in
// lane-major order: a tile waits only on tiles whose blocks took a ticket
// before it, so never on one that is not resident). WIDE: n % EMIT_PER ==
// 0 and the rows aligned, so a thread's positions come in one 8-byte load
// of bytes and of marks and two 16-byte loads of lengths and of offsets.
// `words` and `status` are zero on entry, `ticket` too.
template <bool WIDE>
__global__ void __launch_bounds__(EMIT_THREADS)
    emit_tokens_kernel(const uint8_t* __restrict__ window, const int32_t* __restrict__ best_len,
                       const int32_t* __restrict__ best_off, const uint8_t* __restrict__ is_tok,
                       const int32_t* __restrict__ lit_cw, const int32_t* __restrict__ lit_len,
                       const int32_t* __restrict__ off_cw, const int32_t* __restrict__ off_len,
                       unsigned long long* __restrict__ words, int32_t* __restrict__ total_bits,
                       unsigned long long* status, unsigned* ticket, int n, int tiles,
                       long long num_words) {
  __shared__ Codes c;
  __shared__ unsigned buf[EMIT_WORDS];  // the tile's bits, bit 0 its first
  __shared__ int warp_sums[EMIT_THREADS / 32];
  __shared__ int s_tile;
  __shared__ long long s_first;  // the tile's first bit in the lane
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = (int)atomicAdd(ticket, 1u);
  for (int i = tid; i < EMIT_WORDS; i += EMIT_THREADS) buf[i] = 0;
  __syncthreads();
  const int b = s_tile / tiles, j = s_tile % tiles;
  const int p0 = j * EMIT_TILE + tid * EMIT_PER;
  const size_t row = (size_t)b * n;
  unsigned wb[2] = {0, 0}, mk[2] = {0, 0};  // four bytes a word
  int ln[EMIT_PER], of[EMIT_PER];
  if (WIDE) {
    if (p0 < n) {
      const uint2 w = *reinterpret_cast<const uint2*>(window + row + p0);
      const uint2 m = *reinterpret_cast<const uint2*>(is_tok + row + p0);
      const int4 l0 = *reinterpret_cast<const int4*>(best_len + row + p0);
      const int4 l1 = *reinterpret_cast<const int4*>(best_len + row + p0 + 4);
      const int4 o0 = *reinterpret_cast<const int4*>(best_off + row + p0);
      const int4 o1 = *reinterpret_cast<const int4*>(best_off + row + p0 + 4);
      wb[0] = w.x, wb[1] = w.y, mk[0] = m.x, mk[1] = m.y;
      ln[0] = l0.x, ln[1] = l0.y, ln[2] = l0.z, ln[3] = l0.w;
      ln[4] = l1.x, ln[5] = l1.y, ln[6] = l1.z, ln[7] = l1.w;
      of[0] = o0.x, of[1] = o0.y, of[2] = o0.z, of[3] = o0.w;
      of[4] = o1.x, of[5] = o1.y, of[6] = o1.z, of[7] = o1.w;
    } else {
#pragma unroll
      for (int e = 0; e < EMIT_PER; ++e) ln[e] = of[e] = 0;
    }
  } else {
#pragma unroll
    for (int e = 0; e < EMIT_PER; ++e) {
      const int p = p0 + e;
      const bool in = p < n;
      wb[e >> 2] |= (in ? (unsigned)window[row + p] : 0u) << (8 * (e & 3));
      mk[e >> 2] |= (in ? (unsigned)is_tok[row + p] : 0u) << (8 * (e & 3));
      ln[e] = in ? best_len[row + p] : 0;
      of[e] = in ? best_off[row + p] : 0;
    }
  }
  load_codes(c, lit_cw, lit_len, off_cw, off_len, b);  // after the positions' loads are issued
  __syncthreads();  // the codes

  // Each field once, in stream order; a field of no bits holds nothing.
  unsigned val[2 * EMIT_PER];
  int nb[2 * EMIT_PER];
  int sum = 0;
#pragma unroll
  for (int e = 0; e < EMIT_PER; ++e) {
    const int sh = 8 * (e & 3);
    const Fields f = position_fields(c, (mk[e >> 2] >> sh) & 0xFF, ln[e], of[e],
                                     (wb[e >> 2] >> sh) & 0xFF);
    val[2 * e] = f.n1 > 0 ? (unsigned)f.v1 : 0u;
    val[2 * e + 1] = f.n2 > 0 ? (unsigned)f.v2 : 0u;
    nb[2 * e] = f.n1;
    nb[2 * e + 1] = f.n2;
    sum += f.n1 + f.n2;
  }
  int agg;  // the tile's bits
  const int first = block_scan(sum, warp_sums, agg) - sum;  // this thread's first, in the tile
  unsigned long long* lane_status = status + (size_t)b * tiles;
  if (tid == 0) {
    store_status(lane_status + j, (j == 0 ? ST_PREFIX : ST_AGGREGATE) | (unsigned long long)agg);
  }
  if (tid < 32) {  // warp 0: the tile's first bit in the lane, the lane's end
    const long long before = j == 0 ? 0 : look_back(lane_status, j);
    if (tid == 0) {
      s_first = before;
      if (j > 0) store_status(lane_status + j, ST_PREFIX | (unsigned long long)(before + agg));
      if (j == tiles - 1) {
        const long long end = before + agg;
        const int eod_bits = c.lit_len[EOD];
        total_bits[b] = (int32_t)(end + eod_bits);
        if (eod_bits > 0) {
          unsigned long long* out = words + (size_t)b * num_words;
          const long long v = c.lit_cw[EOD], w = end >> 5;
          const int sh = (int)(end & 31);
          if (w < num_words) or_word(out + w, (unsigned long long)v << sh);
          if (sh > 0 && w + 1 < num_words) or_word(out + w + 1, (unsigned long long)(v >> (32 - sh)));
        }
      }
    }
  }

  // The fields into the tile's words: a thread's first and last words may
  // hold another thread's bits (shared atomics), the words between are its
  // own (stores).
  {
    int w = first >> 5, fill = first & 31;
    unsigned long long acc = 0;  // bits from word w on
    bool own = false;            // word w starts inside this thread's bits
#pragma unroll
    for (int f = 0; f < 2 * EMIT_PER; ++f) {
      acc |= (unsigned long long)val[f] << fill;
      fill += nb[f];
      while (fill >= 32) {
        if (w < EMIT_WORDS) {
          if (own) buf[w] = (unsigned)acc;
          else if ((unsigned)acc) atomicOr(&buf[w], (unsigned)acc);
        }
        own = true;
        acc >>= 32;
        fill -= 32;
        ++w;
      }
    }
    if ((unsigned)acc && w < EMIT_WORDS) atomicOr(&buf[w], (unsigned)acc);
  }
  __syncthreads();  // the words, s_first

  // The tile's words in the lane, whole: global word g holds tile bits
  // [32 g - first, 32 g - first + 32). Its first and last words may hold a
  // neighbour's bits (or the EOD): OR'ed; the rest stored.
  if (agg > 0) {
    const long long s = s_first, g0 = s >> 5, g1 = (s + agg - 1) >> 5;
    const int sh = (int)(s & 31);
    const bool shared_tail = ((s + agg) & 31) != 0;
    unsigned long long* out = words + (size_t)b * num_words;
    for (long long g = g0 + tid; g <= g1 && g < num_words; g += EMIT_THREADS) {
      const int k = (int)(g - g0);
      const unsigned hi = k < EMIT_WORDS ? buf[k] : 0u;
      const unsigned lo = k > 0 && k - 1 < EMIT_WORDS ? buf[k - 1] : 0u;
      const unsigned v = __funnelshift_l(lo, hi, sh);
      if ((k == 0 && sh != 0) || (g == g1 && shared_tail)) {
        or_word(out + g, v);
      } else {
        out[g] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K14: the (key, index) order of short rows
// ---------------------------------------------------------------------------

// S <= 32: a warp a row, 8 rows a block.
__global__ void __launch_bounds__(THREADS)
    lex_order_warp_kernel(const int32_t* __restrict__ key, long long* __restrict__ out, int B,
                          int S) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int i = threadIdx.x & 31;
  if (row >= B) return;  // uniform over the warp
  const int k = i < S ? key[(size_t)row * S + i] : 0;
  int rank = 0;
  for (int j = 0; j < S; ++j) {
    const int kj = __shfl_sync(FULL, k, j);
    rank += (kj < k) || (kj == k && j < i);
  }
  if (i < S) out[(size_t)row * S + rank] = i;
}

// S > 32: a bitonic network on packed words, T = P / E threads a row
// (whole warps), blockDim.x / T rows a block, P * 8 bytes of dynamic
// shared memory a row.
__device__ __forceinline__ unsigned long long pack_key(int32_t key, int index) {
  return ((unsigned long long)((uint32_t)key ^ 0x80000000u) << 32) | (uint32_t)index;
}

constexpr int MAX_SORT_THREADS = 256;  // threads a block of the network

// Compare-exchange words e and e ^ m of this thread, the smaller to the
// lower position (m is a constant once the callers' loops unroll).
template <int E>
__device__ __forceinline__ void in_thread(unsigned long long (&v)[E], int m) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int f = e ^ m;
    if (f < e) continue;
    const bool lt = v[e] < v[f];
    const unsigned long long lo = lt ? v[e] : v[f], hi = lt ? v[f] : v[e];
    v[e] = lo;
    v[f] = hi;
  }
}

// A stage whose partner is word e (MIRROR: word E - 1 - e) of thread t ^ d:
// by shuffles when d < 32, else through shared memory. The thread holds
// the lower position of each pair where (t E) & j == 0 and keeps the
// smaller word there, the larger one elsewhere.
template <int E, bool MIRROR>
__device__ __forceinline__ void across(unsigned long long (&v)[E], unsigned long long* buf,
                                       int t, int T, int d, int j) {
  const bool lower = ((t * E) & j) == 0;
  unsigned long long p[E];
  if (d < 32) {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = __shfl_xor_sync(FULL, v[MIRROR ? E - 1 - e : e], d);
  } else {
    __syncthreads();  // the last shared stage's reads are done
#pragma unroll
    for (int e = 0; e < E; ++e) buf[e * T + t] = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = buf[(MIRROR ? E - 1 - e : e) * T + (t ^ d)];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = (v[e] < p[e]) == lower ? v[e] : p[e];
}

// Every comparator puts the smaller word at the lower position: merge
// width k starts with position i against its mirror i ^ (k - 1) in the
// same k-block, then i against i ^ j for j = k / 4 .. 1. Merges up to
// width E run inside the thread, unrolled; each wider merge is one pass of
// a loop (kept rolled: the code of an unrolled network outgrows the
// instruction cache), its stages of stride j >= E across threads and its
// last log2(E) stages inside the thread.
template <int P, int E>
__global__ void __launch_bounds__(MAX_SORT_THREADS)
    lex_order_block_kernel(const int32_t* __restrict__ key, long long* __restrict__ out, int B,
                           int S) {
  constexpr int T = P / E;
  static_assert(T % 32 == 0 && T <= MAX_SORT_THREADS, "a row takes whole warps");
  extern __shared__ unsigned long long lex_smem[];
  const int r = threadIdx.x / T, t = threadIdx.x % T;
  const int row = blockIdx.x * (blockDim.x / T) + r;
  const bool live = row < B;  // a padded row still meets every barrier
  unsigned long long* buf = lex_smem + (size_t)r * P;
  unsigned long long v[E];  // v[e]: position t * E + e
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * T + t;  // any start order sorts: load coalesced
    v[e] = live && i < S ? pack_key(key[(size_t)row * S + i], i) : ~0ull;
  }
#pragma unroll
  for (int k = 2; k <= E; k *= 2) {
    in_thread(v, k - 1);
#pragma unroll
    for (int j = k / 4; j >= 1; j /= 2) in_thread(v, j);
  }
#pragma unroll 1
  for (int k = 2 * E; k <= P; k *= 2) {
    across<E, true>(v, buf, t, T, k / E - 1, k / 2);
#pragma unroll 1
    for (int j = k / 4; j >= E; j /= 2) across<E, false>(v, buf, t, T, j / E, j);
#pragma unroll
    for (int j = E / 2; j >= 1; j /= 2) in_thread(v, j);
  }
  // Out through shared memory (index i at i + i / 32: no bank conflicts),
  // so that each store instruction writes contiguous indices.
  int* idx = reinterpret_cast<int*>(buf);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    idx[i + (i >> 5)] = (int)(uint32_t)v[e];
  }
  __syncthreads();
  if (live) {
    for (int i = t; i < S; i += T) out[(size_t)row * S + i] = idx[i + (i >> 5)];
  }
}

// Rows at which the P = 512 network takes its throughput layout: on an
// H100 the crossover at 288 keys lies between 512 and 1024 rows (PERF.md).
constexpr int LEX_THROUGHPUT_ROWS = 1024;

template <int P, int E, int ROWS = 1>
int launch_lex_order(const void* key, void* out, int B, int S, cudaStream_t st) {
  static_assert(ROWS * (P / E) <= MAX_SORT_THREADS, "a block's threads");
  const size_t smem = (size_t)ROWS * P * sizeof(unsigned long long);
  lex_order_block_kernel<P, E><<<(B + ROWS - 1) / ROWS, ROWS * (P / E), smem, st>>>(
      (const int32_t*)key, (long long*)out, B, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zt_prep_lanes(const void* ll, const void* ol, const void* window,
                             const void* mlens, const void* moffs, const void* length, void* lit,
                             void* p1, void* p2, void* varlen40, int B, int n, void* stream) {
  if (B < 0 || n < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const dim3 grid((n + TILE - 1) / TILE, B);
    prep_lanes_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ll, (const int32_t*)ol, (const uint8_t*)window, (const int32_t*)mlens,
        (const int32_t*)moffs, (const int32_t*)length, (int32_t*)lit, (int32_t*)p1,
        (int32_t*)p2, (int32_t*)varlen40, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int zt_token_hist(const void* window, const void* lens, const void* offs,
                             const void* is_tok, void* lit_hist, void* off_hist, int B, int n,
                             long long lens_lane, long long lens_pos, long long offs_lane,
                             long long offs_pos, void* stream) {
  if (B < 0 || n < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const dim3 grid((n + HIST_TILE - 1) / HIST_TILE, B);
    const bool wide = n % RUN == 0 && (uintptr_t)window % 8 == 0 && (uintptr_t)is_tok % 8 == 0;
    const bool eager = offs_pos == 1;
    auto kernel = wide ? (eager ? token_hist_kernel<true, true> : token_hist_kernel<true, false>)
                       : (eager ? token_hist_kernel<false, true> : token_hist_kernel<false, false>);
    kernel<<<grid, HIST_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)window, (const int32_t*)lens, (const int32_t*)offs,
        (const uint8_t*)is_tok, (int32_t*)lit_hist, (int32_t*)off_hist, n, lens_lane, lens_pos,
        offs_lane, offs_pos);
  }
  return (int)cudaGetLastError();
}

// scratch: B * num_words + B * ceil(n / EMIT_TILE) + 1 int64, the words
// (B, num_words), the tiles' status words and the ticket, zeroed here by
// one memset on the stream before the launch.
extern "C" int zt_emit_tokens(const void* window, const void* best_len, const void* best_off,
                              const void* is_tok, const void* lit_cw, const void* lit_len,
                              const void* off_cw, const void* off_len, void* scratch,
                              void* total_bits, int B, int n, long long num_words,
                              void* stream) {
  if (B < 0 || n < 1 || num_words < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const int tiles = (n + EMIT_TILE - 1) / EMIT_TILE;
  if ((long long)B * tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* words = (unsigned long long*)scratch;
  unsigned long long* status = words + (size_t)B * num_words;
  unsigned* ticket = (unsigned*)(status + (size_t)B * tiles);
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, ((size_t)B * num_words + (size_t)B * tiles + 1) * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  const bool wide = n % EMIT_PER == 0 && (uintptr_t)window % 8 == 0 &&
                    (uintptr_t)is_tok % 8 == 0 && (uintptr_t)best_len % 16 == 0 &&
                    (uintptr_t)best_off % 16 == 0;
  auto kernel = wide ? emit_tokens_kernel<true> : emit_tokens_kernel<false>;
  kernel<<<(unsigned)(B * tiles), EMIT_THREADS, 0, st>>>(
      (const uint8_t*)window, (const int32_t*)best_len, (const int32_t*)best_off,
      (const uint8_t*)is_tok, (const int32_t*)lit_cw, (const int32_t*)lit_len,
      (const int32_t*)off_cw, (const int32_t*)off_len, words, (int32_t*)total_bits, status,
      ticket, n, tiles, num_words);
  return (int)cudaGetLastError();
}

// S <= 32: the warp kernel. Else the network on rows padded to P =
// 2^ceil(log2 S) >= 64, in the layout the width and B pick (above).
extern "C" int zt_lex_order(const void* key, void* out, int B, int S, void* stream) {
  if (B < 0 || S < 1 || S > MAX_SORT) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= 32) {
    const int per_block = THREADS / 32;
    lex_order_warp_kernel<<<(B + per_block - 1) / per_block, THREADS, 0, st>>>(
        (const int32_t*)key, (long long*)out, B, S);
    return (int)cudaGetLastError();
  }
  if (S <= 64) return launch_lex_order<64, 2>(key, out, B, S, st);
  if (S <= 128) return launch_lex_order<128, 2>(key, out, B, S, st);
  if (S <= 256) return launch_lex_order<256, 2>(key, out, B, S, st);
  if (S <= 512) {
    return B >= LEX_THROUGHPUT_ROWS ? launch_lex_order<512, 16, 8>(key, out, B, S, st)
                                    : launch_lex_order<512, 2>(key, out, B, S, st);
  }
  return launch_lex_order<1024, 4>(key, out, B, S, st);
}
