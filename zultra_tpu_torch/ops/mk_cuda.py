"""Moffat-Katajainen phases 1-2 and Kraft-sum length limiting (kernels
``csrc/mk.cu``), their plain PyTorch versions, and plain models of the
kernels' schedules.

Same contracts as zultra_tpu.ops.mk_pallas.mk_phase12_pallas and
kraft_limit_pallas (reference src/huffman/huffencoder.c:157-270 and
:279-346). Every histogram of a batch is a lane; the plain versions are
loops over the (at most 288-entry) symbol axis with the lanes as
vectors. The kernels take any S up to 288: the JAX package's
``S % 8 == 0`` guard is a TPU tiling limit, not semantics.

The MK kernel runs one of two layouts, chosen by the number of lanes B
at launch: a thread per lane (32 lanes a block, the rows staged by one
bulk copy and transposed in shared memory) above ``WARP_LANES`` lanes, a
warp per lane (the row copied by one coalesced load, phase 2 by pointer
jumping) at or below it. The Kraft kernel runs a warp per lane at every
B: it was as fast or faster at every batch the path gives it.
``mk_phase12_model`` and ``kraft_limit_model`` are the kernels'
schedules in plain Python, with counters of the paths they took; each
asserts the facts its schedule rests on.

Why the MK schedule is exact (phase 1 is the plain form's pick rule,
two picks a merge step t, for any weights):
- A leaf slot is never written before it is read: before step t at most
  t - 1 internal nodes were consumed, so the leaf index is >= t + 1 at
  both picks, while every write so far went to a slot <= t - 1. The leaf
  queue reads the input row, and its next values are fetched ahead.
- An internal node is read only after it was made (the pick rule reads
  it when ``internal < t``, or when the leaves are used up, which forces
  ``internal < t``), and its slot changes only when it is consumed. So
  the heads of both queues live in registers, refilled from the array or
  forwarded from ``w``, the node made one step before, and both picks of
  a step are one compare and select on them.
- Phase 2 writes only a[t] at step t, so a parent's depth is the one
  just computed (parent t + 1) or a read of the array issued ahead,
  after the stores of the steps before (the slot is unchanged since, a
  repeated parent included).
- With n = n_used <= S, phase 1 consumes every internal node but the
  root n - 2, and slot t of a consumed node holds t' + 1, where t' > t
  is the step that consumed it: its parent is t'. So every node phase 2
  updates has its parent above it, and depths follow by pointer jumping
  over the parent links in ceil(log2 depth) rounds. The warp layout checks that fact on
  the lane (it can fail only for n_used > S) and otherwise runs the
  serial sweep.
Kraft: a lane whose Kraft sum equals 2^max_len stops both sweeps at
their first test, so it is copied; phase B's ``m // u`` with
u = 2^max_len >> len is ``m >> (max_len - len)`` for 0 <= len <= max_len.
"""

from __future__ import annotations

import torch

from .. import _build
from . import count_launch
from .symbol_map import floor_log2

MAX_S = 288  # the kernels' shared-memory arrays hold 288 symbols per lane
# The most lanes for which an MK call runs a warp per lane (else a thread
# per lane), from mk_bench's layout sweep on an H100 (PERF.md §6).
WARP_LANES = 512
I32 = torch.int32
I64 = torch.int64


def _check(name: str, rows: torch.Tensor, *lanes: torch.Tensor) -> None:
    _build.check_cuda(name, rows, I32, 2)
    for t in lanes:
        _build.check_cuda(name, t, I32, 1)
        if t.shape[0] != rows.shape[0]:
            raise ValueError(f"{name}: expected one entry per lane")
    if not 1 <= rows.shape[1] <= MAX_S:
        raise ValueError(f"{name}: {rows.shape[1]} symbols, the kernel takes 1..{MAX_S}")


def mk_phase12(a0: torch.Tensor, n_used: torch.Tensor) -> torch.Tensor:
    """a0 (B, S) int32 weights sorted ascending (slots past n_used
    arbitrary), n_used (B,) int32 -> (B, S) int32: the in-place array
    after the two-queue merge and the parent-chain depths (internal
    node depths at t < n_used - 1)."""
    if a0.device.type == "cpu":
        return mk_phase12_plain(a0, n_used)
    return _launch_mk12(a0, n_used, a0.shape[0] <= WARP_LANES)


def _launch_mk12(a0: torch.Tensor, n_used: torch.Tensor, warp_per_lane: bool) -> torch.Tensor:
    """Launch the MK kernel in the given layout (``mk_bench`` and the card
    tests time and check both; ``mk_phase12`` chooses by B)."""
    _check("mk12", a0, n_used)
    B, S = a0.shape
    out = torch.empty_like(a0)
    _build.launch("zt_mk12", a0.data_ptr(), n_used.data_ptr(), out.data_ptr(), B, S,
                  int(warp_per_lane))
    count_launch("mk12")
    return out


def mk_phase12_plain(a0: torch.Tensor, n_used: torch.Tensor) -> torch.Tensor:
    B, S = a0.shape
    dev = a0.device
    rows = torch.arange(B, dtype=I64, device=dev)
    # Column S is a dump slot for the writes of lanes that take no
    # internal node (the JAX scan drops them).
    a_ext = torch.zeros((B, S + 1), dtype=I32, device=dev)
    a_ext[:, :S] = a0
    a = a_ext[:, :S]

    # Phase 1: two-queue merge over t = 0..S-2.
    leaf = torch.zeros(B, dtype=I64, device=dev)
    internal = torch.zeros(B, dtype=I64, device=dev)
    n_used64 = n_used.to(I64)

    def pick(t, w_acc, active):
        nonlocal leaf, internal
        av_leaf = a[rows, torch.clamp(leaf, 0, S - 1)]
        av_int = a[rows, torch.clamp(internal, 0, S - 1)]
        take_int = ((leaf >= n_used64) | ((internal < t) & (av_int < av_leaf))) & active
        w_acc = w_acc + torch.where(take_int, av_int, av_leaf)
        a_ext.scatter_(1, torch.where(take_int, internal, S)[:, None], t + 1)
        internal = internal + take_int.to(I64)
        leaf = leaf + (active & ~take_int).to(I64)
        return w_acc

    for t in range(S - 1):
        active = t < n_used64 - 1
        w = pick(t, torch.zeros(B, dtype=I32, device=dev), active)
        w = pick(t, w, active)
        a[:, t] = torch.where(active, w, a[:, t])

    # Phase 2: internal depths via the parent chain (parents sit at
    # larger indices, so a backward sweep resolves each in one step).
    root = torch.clamp(n_used64 - 2, 0, S - 1)
    a[rows, root] = 0
    for t in range(S - 3, -1, -1):
        active = t <= n_used64 - 3
        parent = a[:, t].to(I64) - 1
        pdepth = a[rows, torch.clamp(parent, 0, S - 1)]
        a[:, t] = torch.where(active, pdepth + 1, a[:, t])
    return a.contiguous()


def kraft_limit(clamped_sorted: torch.Tensor, n_used: torch.Tensor, kraft0: torch.Tensor,
                max_len: int) -> torch.Tensor:
    """clamped_sorted (B, S) int32 lengths already min(., max_len) and
    sorted by (length, symbol) (slots past n_used arbitrary), n_used and
    kraft0 (B,) int32 (kraft0 the Kraft sum of the clamped lengths),
    max_len 1..15 -> (B, S) int32 repaired sorted lengths: lengthen from
    position S-1 down while the sum is over 2^max_len, then shorten from
    position 0 up while room remains."""
    if clamped_sorted.device.type == "cpu":
        return kraft_limit_plain(clamped_sorted, n_used, kraft0, max_len)
    _check("kraft", clamped_sorted, n_used, kraft0)
    if not 1 <= max_len <= 15:
        raise ValueError(f"kraft: max_len {max_len} outside 1..15")
    B, S = clamped_sorted.shape
    out = torch.empty_like(clamped_sorted)
    _build.launch("zt_kraft", clamped_sorted.data_ptr(), n_used.data_ptr(), kraft0.data_ptr(),
                  out.data_ptr(), B, S, max_len)
    count_launch("kraft")
    return out


def kraft_limit_plain(clamped_sorted: torch.Tensor, n_used: torch.Tensor, kraft0: torch.Tensor,
                      max_len: int) -> torch.Tensor:
    B, S = clamped_sorted.shape
    full = 1 << max_len
    lens = clamped_sorted.clone()
    kraft = kraft0.clone()

    # Phase A: lengthen the rarest (descending sorted position).
    for p in range(S - 1, -1, -1):
        l = lens[:, p]
        active = (p < n_used) & (kraft > full) & (l < max_len)
        r = (full >> l) - (kraft - full)
        l_new = torch.where(r <= 0, max_len,
                            torch.maximum(l, max_len - floor_log2(torch.clamp(r, min=1))))
        l_new = torch.where(active, torch.clamp(l_new, max=max_len), l)
        kraft = kraft - (full >> l) + (full >> l_new)
        lens[:, p] = l_new

    # Phase B: re-shorten the most frequent (ascending sorted position).
    for p in range(S):
        l = lens[:, p]
        active = p < n_used
        u = full >> l
        m = torch.clamp(full - kraft, min=0) // torch.clamp(u, min=1)
        d = torch.where(active, floor_log2(m + 1), 0)
        d = torch.minimum(d, torch.clamp(l - 1, min=0))
        kraft = kraft + u * ((1 << d) - 1)
        lens[:, p] = l - d
    return lens


MK_COUNTERS = ("pick_ll", "pick_li", "pick_ii", "head_forwarded", "head_read",
               "depth_forwarded", "depth_read", "jump_lanes", "jump_rounds", "serial_lanes")
KRAFT_COUNTERS = ("fit", "repaired", "lengthened", "shortened")


def _i32(x: int) -> int:
    """x wrapped to int32, as the kernels' and the plain form's adds wrap."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def mk_phase12_model(a0: torch.Tensor, n_used: torch.Tensor, warp_per_lane: bool = False):
    """The MK kernel's schedule on CPU tensors, lane by lane -> (the (B, S)
    array of ``mk_phase12_plain``, {counter: count} over ``MK_COUNTERS``).
    Phase 1 keeps the two leaf heads and two internal heads in locals,
    fetches the next two of each a step ahead, resolves both picks of a
    step together (``pick_ll``, ``pick_li``, ``pick_ii``) and refills an
    internal head from ``w`` (``head_forwarded``) or the array
    (``head_read``). Phase 2 is the serial sweep with the parent's depth
    forwarded from the step before (``depth_forwarded``) or read ahead
    (``depth_read``), or with ``warp_per_lane`` pointer jumping
    (``jump_lanes``, ``jump_rounds``) where every updated node's parent
    lies above it."""
    B, S = a0.shape
    counts = dict.fromkeys(MK_COUNTERS, 0)
    rows = a0.tolist()
    for row, n in zip(rows, n_used.tolist()):
        _mk_phase1_model(row, n, S, counts)
        _mk_phase2_model(row, n, S, warp_per_lane, counts)
    return torch.tensor(rows, dtype=I32).view(B, S), counts


def _mk_phase1_model(a: list, n: int, S: int, counts: dict) -> None:
    written = set()  # slots written so far: no leaf is read from one

    def leaf(i):
        j = min(i, S - 1)
        assert j not in written, "a leaf read a slot written before"
        return a[j]

    steps = min(n - 1, S - 1)
    if steps <= 0:
        return
    L = I = 0  # leaf and internal queue heads; their values:
    l0, l1 = leaf(0), leaf(1)
    i0 = i1 = 0  # nodes I, I + 1 (meaningful once made: index < t)
    for t in range(steps):
        l2, l3 = leaf(L + 2), leaf(L + 3)  # fetched ahead
        x2, x3 = a[min(I + 2, S - 1)], a[min(I + 3, S - 1)]
        v0, v1 = I < t, I + 1 < t
        if L >= n or (v0 and i0 < l0):  # first pick: internal
            second_int = L >= n or (v1 and i1 < l0)
            assert v0 and (v1 or not second_int), "an internal node read before it was made"
            m, w = (2, i0 + i1) if second_int else (1, i0 + l0)
        else:
            second_int = L + 1 >= n or (v0 and i0 < l1)
            assert v0 or not second_int, "an internal node read before it was made"
            m, w = (1, l0 + i0) if second_int else (0, l0 + l1)
        w = _i32(w)
        counts[("pick_ll", "pick_li", "pick_ii")[m]] += 1
        k = 2 - m
        for j in range(k):
            assert min(L + j, S - 1) not in written, "a leaf read a slot written before"
        for j in range(m):
            a[I + j] = t + 1
            written.add(I + j)
        a[t] = w
        written.add(t)
        l0, l1 = (l0, l1, l2, l3)[k : k + 2]
        L += k
        cand = [w if I + j == t else v for j, v in enumerate((i0, i1, x2, x3))]
        for j in (m, m + 1):  # the heads of step t + 1 that will have been made
            if I + j <= t:
                if I + j == t:
                    counts["head_forwarded"] += 1
                elif j >= 2:
                    counts["head_read"] += 1
        i0, i1 = cand[m], cand[m + 1]
        I += m


def _mk_phase2_model(a: list, n: int, S: int, warp_per_lane: bool, counts: dict) -> None:
    a[min(max(n - 2, 0), S - 1)] = 0  # the root, written for every lane
    tmax = min(S - 3, n - 3)  # nodes 0..tmax get their depths
    if tmax < 0:
        return
    if warp_per_lane:
        ptr = [min(max(a[t] - 1, 0), S - 1) for t in range(tmax + 1)]
        above = all(p > t for t, p in enumerate(ptr))
        assert above or n > S, "a node phase 2 updates has its parent at or below it"
        if above:
            counts["jump_lanes"] += 1
            d = [1] * (tmax + 1)
            while any(p <= tmax for p in ptr):
                d = [d[t] + d[p] if p <= tmax else d[t] for t, p in enumerate(ptr)]
                ptr = [ptr[p] if p <= tmax else p for p in ptr]
                counts["jump_rounds"] += 1
            for t in range(tmax + 1):  # terminals lie above tmax: not written here
                a[t] = _i32(d[t] + a[ptr[t]])
            return
    counts["serial_lanes"] += 1
    d_prev = 0
    for t in range(tmax, -1, -1):
        p = min(max(a[t] - 1, 0), S - 1)
        if p == t + 1 and t + 1 <= tmax:  # the depth just computed, in a register
            assert d_prev == a[p]
            pd = d_prev
            counts["depth_forwarded"] += 1
        else:  # read ahead: only a[t + 1] was written since
            pd = a[p]
            counts["depth_read"] += 1
        d_prev = a[t] = _i32(pd + 1)


def kraft_limit_model(clamped_sorted: torch.Tensor, n_used: torch.Tensor, kraft0: torch.Tensor,
                      max_len: int):
    """The Kraft kernel's schedule on CPU tensors, lane by lane -> (the
    (B, S) lengths of ``kraft_limit_plain``, {counter: count} over
    ``KRAFT_COUNTERS``). A lane whose Kraft sum is 2^max_len is copied
    (``fit``); any other (``repaired``) lengthens from its last used
    position while the sum is over (``lengthened`` steps) and shortens
    from position 0 while room remains (``shortened`` steps), phase B
    dividing by a shift."""
    B, S = clamped_sorted.shape
    full = 1 << max_len
    counts = dict.fromkeys(KRAFT_COUNTERS, 0)
    rows = clamped_sorted.tolist()
    for row, n, kraft in zip(rows, n_used.tolist(), kraft0.tolist()):
        if kraft == full:
            counts["fit"] += 1
            continue
        counts["repaired"] += 1
        n = min(n, S)
        p = n - 1
        while p >= 0 and kraft > full:
            ln = row[p]
            if ln < max_len:
                r = (full >> ln) - (kraft - full)
                new = min(max_len if r <= 0 else max(ln, max_len - (r.bit_length() - 1)), max_len)
                kraft += (full >> new) - (full >> ln)
                row[p] = new
            counts["lengthened"] += 1
            p -= 1
        p = 0
        while p < n and kraft < full:
            ln = row[p]
            assert 1 <= ln <= max_len, "the shift stands for the division only here"
            m = (full - kraft) >> (max_len - ln)
            d = min((m + 1).bit_length() - 1, max(ln - 1, 0))
            kraft += (full >> ln) * ((1 << d) - 1)
            row[p] = ln - d
            counts["shortened"] += 1
            p += 1
    return torch.tensor(rows, dtype=I32).view(B, S), counts
