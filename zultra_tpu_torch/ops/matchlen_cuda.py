"""Match lengths of (pos, prev) pairs (kernel ``csrc/matchlen.cu``), their
plain PyTorch version, and a plain model of the kernel's schedule.

The counterpart of zultra_tpu/ops/matchlen.py (``match_lengths_pallas``):
for each pair, the length of the common prefix of data[pos:] and
data[prev:], counted up to min(n - pos, n - prev, 259) (0 when that cap
is not positive) and then clamped to MAX_MATCH_SIZE (258). So pos == prev
gives min(cap, 258), and a run of 259 or more equal bytes gives 258. The
TPU kernel's 256-pair tiles and its 128-aligned, zero-padded loads were
TPU layout, not semantics, and are not carried over. Positions are meant
to lie in [0, n); a pair with a negative index gets 0 here (the TPU
kernel's load is undefined there).

The kernel runs a thread per pair over the first ``HEAD`` bytes, read as
the aligned words around each span, and hands a pair still equal past
them to a warp, whose 32 lanes compare 8 bytes each: one round reaches
the cap. ``match_lengths_model`` is that schedule in numpy, at a chosen
alignment of the data, with counters of the paths it took; it asserts
that no load leaves the aligned 16-byte word of data[n - 1] and that a
warp's round always finds the pair's end.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import count_launch
from ..constants import MAX_MATCH_SIZE

SPAN = MAX_MATCH_SIZE + 1  # bytes compared per pair at most
PLAIN_CHUNK = 16384  # pairs gathered at once by the plain form
THREADS = 256  # csrc/matchlen.cu: pairs per block, and the most a block queues
# csrc/matchlen.cu's K: bytes each thread compares before a pair goes to
# the warp tail, from the corpus pairs' length distribution (PERF.md §6).
HEAD = 16
MODEL_COUNTERS = ("pairs", "no_span", "head_done", "queued", "at_cap", "at_258",
                  "bytes_loaded", "max_block_queue")


def _check(data: torch.Tensor, positions: torch.Tensor, prev_positions: torch.Tensor) -> None:
    if data.dim() != 1 or positions.dim() != 1 or prev_positions.shape != positions.shape:
        raise ValueError("matchlen: data (n,), positions and prev_positions (P,) expected")


def match_lengths(data: torch.Tensor, positions: torch.Tensor,
                  prev_positions: torch.Tensor) -> torch.Tensor:
    """data (n,) uint8, positions / prev_positions (P,) int32 -> (P,)
    int32 match lengths."""
    _check(data, positions, prev_positions)
    if data.device.type == "cpu":
        return match_lengths_plain(data, positions, prev_positions)
    _build.check_cuda("matchlen data", data, torch.uint8, 1)
    _build.check_cuda("matchlen positions", positions, torch.int32, 1)
    _build.check_cuda("matchlen prev_positions", prev_positions, torch.int32, 1)
    out = torch.empty(positions.shape, dtype=torch.int32, device=data.device)
    if out.numel() == 0:
        return out
    _build.launch("zt_matchlen", data.data_ptr(), data.numel(), positions.data_ptr(),
                  prev_positions.data_ptr(), out.data_ptr(), positions.numel())
    count_launch("matchlen")
    return out


def match_lengths_plain(data: torch.Tensor, positions: torch.Tensor,
                        prev_positions: torch.Tensor) -> torch.Tensor:
    """Gather the (pairs, 259) byte spans a chunk at a time, compare them,
    and take the first mismatch (or the cap)."""
    _check(data, positions, prev_positions)
    n = data.numel()
    dev = data.device
    out = torch.zeros(positions.shape, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    k = torch.arange(SPAN, dtype=torch.int64, device=dev)
    for lo in range(0, positions.numel(), PLAIN_CHUNK):
        p = positions[lo : lo + PLAIN_CHUNK].to(torch.int64)
        q = prev_positions[lo : lo + PLAIN_CHUNK].to(torch.int64)
        cap = torch.clamp(n - torch.maximum(p, q), 0, SPAN)
        cap = torch.where((p < 0) | (q < 0), 0, cap)
        ia = torch.clamp(p[:, None] + k, 0, n - 1)
        ib = torch.clamp(q[:, None] + k, 0, n - 1)
        stop = (data[ia] != data[ib]) | (k >= cap[:, None])
        # A row with cap SPAN and SPAN equal bytes has no stop; one
        # always-true column at k = SPAN gives it length SPAN (-> 258).
        stop = torch.cat([stop, torch.ones((stop.shape[0], 1), dtype=torch.bool, device=dev)], 1)
        first = torch.argmax(stop.to(torch.int32), dim=1)
        out[lo : lo + PLAIN_CHUNK] = torch.clamp(first, max=MAX_MATCH_SIZE).to(torch.int32)
    return out


# The lengths planted at every residue pair by ``edge_pairs``: each side
# of the head.
EDGE_LENGTHS = (HEAD - 1, HEAD, HEAD + 1)
LONG_LENGTHS = (0, 1, 100, 257, 258, 259, 300)


def edge_pairs(seed: int = 9):
    """A seeded edge case for the kernel, its model and chip_smoke.py ->
    (data uint8, pos int32, prev int32) numpy arrays. In order: a pair
    for every (p mod 16, q mod 16) at each length of ``EDGE_LENGTHS``;
    32 random residue pairs at each of ``LONG_LENGTHS`` (a planted match
    of that length, which the clamp cuts to 258 from 259 up; pos and
    prev swapped at random); 18 pairs whose span runs to the end (the
    last 700 bytes repeat with period 37); 25 pairs with pos == prev;
    and 8 pairs with a negative index or one >= n (length 0)."""
    rng = np.random.default_rng(seed)
    specs = [(a, b, L) for L in EDGE_LENGTHS for a in range(16) for b in range(16)]
    specs += [(int(a), int(b), L) for L in LONG_LENGTHS for a, b in rng.integers(0, 16, (32, 2))]
    data = rng.integers(0, 256, sum(2 * L + 80 for _, _, L in specs) + 2000, dtype=np.uint8)
    pos, prev = [], []
    at = 16
    for a, b, L in specs:
        q = (at & ~15) + 16 + b
        p = ((q + L + 24) & ~15) + 16 + a
        data[p : p + L] = data[q : q + L]
        data[p + L] = data[q + L] ^ 0xFF
        pair = (p, q) if rng.random() < 0.5 else (q, p)
        pos.append(pair[0])
        prev.append(pair[1])
        at = p + L + 1
    n = at + 700
    data = data[:n]
    data[n - 700 :] = np.resize(data[n - 737 : n - 700].copy(), 700)
    ends = [1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 258, 259, 260, 600]
    pos += [n - c for c in ends]
    prev += [n - c - 37 for c in ends]
    same = [int(i) for i in rng.integers(0, n, 20)] + [0, n - 1, n - 8, n - 258, n - 259]
    pos += same
    prev += same
    pos += [-1, 5, -(1 << 31), n, n + 100, 0, (1 << 31) - 1, n - 1]
    prev += [5, -3, 0, 0, 3, n, 0, n]
    return data, np.array(pos, np.int64).astype(np.int32), np.array(prev, np.int64).astype(np.int32)


# -- the kernel's schedule, as a plain model --------------------------------

POISON = 0xA5  # the model's bytes outside the data: a missed cap shows as a longer match


class _Memory:
    """The data at byte address ``base_mod`` of a flat address space,
    read only as the kernel reads it: aligned words below ``lim``, the
    first address past the aligned 16-byte word of data[n - 1]."""

    def __init__(self, data: np.ndarray, base_mod: int, counts: dict):
        n = len(data)
        self.lim = ((base_mod + n - 1) & ~15) + 16 if n else 0
        self.mem = np.full(self.lim + 16, POISON, np.uint8)
        self.mem[base_mod : base_mod + n] = data
        self.counts = counts

    def words(self, at: np.ndarray, width: int) -> np.ndarray:
        """(m,) aligned addresses below lim -> (m, width) bytes."""
        assert (at % width == 0).all(), "an unaligned word load"
        assert (at >= 0).all() and (at + width <= self.lim).all(), \
            "a load outside the aligned words from data[0]'s to data[n - 1]'s"
        self.counts["bytes_loaded"] += int(at.size) * width
        return self.mem[at[:, None] + np.arange(width)]


def _u32(b: np.ndarray) -> np.ndarray:
    """(m, 4k) bytes -> (m, k) little-endian uint32 words."""
    return np.ascontiguousarray(b).view("<u4").astype(np.uint64)


def _low_byte(d: np.ndarray) -> np.ndarray:
    """Index of the lowest non-zero byte of each non-zero uint64 d."""
    low = d & (~d + np.uint64(1))
    return (np.log2(np.where(d == 0, 1, low).astype(np.float64)).astype(np.int64)) >> 3


def _load_head(mem: _Memory, addr: np.ndarray) -> np.ndarray:
    """load_head: the HEAD bytes at addr as (m, HEAD / 4) uint32 words,
    from the HEAD / 16 + 1 aligned 16-byte words they touch (a word at or
    past lim reads as 0), shifted down by a log shifter and a funnel
    shift."""
    loads = HEAD // 16 + 1
    base = addr & ~15
    raw = np.zeros((addr.size, loads * 16), np.uint8)
    for i in range(loads):
        at = base + i * 16
        ok = at < mem.lim
        if ok.any():
            raw[ok, i * 16 : (i + 1) * 16] = mem.words(at[ok], 16)
    r = _u32(raw)
    s = addr & 15
    nw = r.shape[1]
    bit = 1
    while bit < 4:
        sel = ((s >> 2) & bit) != 0
        r[sel, : nw - bit] = r[sel, bit:]
        bit <<= 1
    sh = ((s & 3) * 8).astype(np.uint64)[:, None]
    k = HEAD // 4
    return ((r[:, 1 : k + 1] << np.uint64(32) | r[:, :k]) >> sh) & np.uint64(0xFFFFFFFF)


def _load8(mem: _Memory, addr: np.ndarray) -> np.ndarray:
    """load8: the 8 bytes at addr (<= data + n - 1) as uint64, from the
    aligned 8-byte word that holds addr and, when addr is unaligned and
    the next word lies below lim, that word."""
    base = addr & ~7
    sh = ((addr & 7) * 8).astype(np.uint64)
    lo = _u32(mem.words(base, 8))
    lo = lo[:, 0] | lo[:, 1] << np.uint64(32)
    hi = np.zeros_like(lo)
    nxt = (sh != 0) & (base + 8 < mem.lim)
    if nxt.any():
        w = _u32(mem.words(base[nxt] + 8, 8))
        hi[nxt] = w[:, 0] | w[:, 1] << np.uint64(32)
    shifted = (lo >> sh) | (hi << (np.uint64(64) - sh))
    return np.where(sh != 0, shifted, lo)


def match_lengths_model(data: torch.Tensor, positions: torch.Tensor,
                        prev_positions: torch.Tensor, base_mod: int = 0):
    """The kernel's schedule on CPU tensors, with the data at an address
    of ``base_mod`` mod 16 -> (the lengths of ``match_lengths_plain``,
    {counter: count} over ``MODEL_COUNTERS``). Counters: ``no_span``
    (cap <= 0: no load), ``head_done`` (ended within the head),
    ``queued`` (handed to the warp tail), ``at_cap`` (ended by the cap
    with no mismatch), ``at_258``, ``bytes_loaded`` (by every load,
    head and tail), ``max_block_queue`` (the longest queue of a block of
    ``THREADS`` pairs)."""
    _check(data, positions, prev_positions)
    assert 0 <= base_mod < 16
    d = data.numpy()
    n = len(d)
    p = positions.numpy().astype(np.int64)
    q = prev_positions.numpy().astype(np.int64)
    counts = dict.fromkeys(MODEL_COUNTERS, 0)
    counts["pairs"] = p.size
    cap = np.minimum(n - np.maximum(p, q), SPAN)
    cap = np.where((p < 0) | (q < 0) | (cap < 0), 0, cap)
    out = np.zeros(p.size, np.int64)  # lengths before the clamp to 258
    live = np.flatnonzero(cap > 0)
    counts["no_span"] = p.size - live.size
    mem = _Memory(d, base_mod, counts)

    # head: a thread per pair
    a = _load_head(mem, base_mod + p[live])
    b = _load_head(mem, base_mod + q[live])
    dh = a ^ b
    length = np.full(live.size, HEAD, np.int64)
    for i in range(HEAD // 4 - 1, -1, -1):
        diff = dh[:, i] != 0
        length[diff] = 4 * i + _low_byte(dh[diff, i])
    length = np.minimum(length, cap[live])
    more = (length == HEAD) & (cap[live] > HEAD)
    out[live[~more]] = length[~more]
    counts["head_done"] = int((~more).sum())
    counts["queued"] = int(more.sum())
    if more.any():
        counts["max_block_queue"] = int(np.bincount(live[more] // THREADS).max())
    assert counts["max_block_queue"] <= THREADS

    # tail: a warp per queued pair; lane j compares bytes [K + 8j, K + 8j + 8)
    tail = live[more]
    tcap = cap[tail][:, None]
    k0 = HEAD + 8 * np.arange(32)[None, :]
    dt = np.ones((tail.size, 32), np.uint64)  # past the cap: a stop at byte 0
    rows, lanes = np.nonzero(k0 < tcap)
    if rows.size:
        off = k0[0, lanes]
        x = (_load8(mem, base_mod + p[tail][rows] + off)
             ^ _load8(mem, base_mod + q[tail][rows] + off))
        rem = tcap[rows, 0] - off
        x |= np.where(rem < 8, np.uint64(1) << (8 * np.minimum(rem, 7)).astype(np.uint64),
                      np.uint64(0))
        dt[rows, lanes] = x
    at = np.where(dt != 0, _low_byte(dt), 8)
    hit = at < 8
    assert hit.any(axis=1).all(), "a warp's round found no end of its pair"
    src = np.argmax(hit, axis=1)
    out[tail] = HEAD + 8 * src + at[np.arange(tail.size), src]

    counts["at_cap"] = int((out[live] == cap[live]).sum())
    out = np.minimum(out, MAX_MATCH_SIZE)
    counts["at_258"] = int((out == MAX_MATCH_SIZE).sum())
    return torch.from_numpy(out.astype(np.int32)), counts
