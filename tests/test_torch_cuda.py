"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same inputs (exact equality — all integer), and
the one-shot path and the streaming push API against zultra_tpu's native
engine (exact bytes).
Skips without CUDA; run on the card with
``python -m pytest tests/test_torch_cuda.py``."""

import collections
import hashlib
import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

import zultra_tpu as zt
from zultra_tpu import engine
from zultra_tpu_torch import FINALIZE, DeviceWindowEngine, Stream, compress, ops, profiling
from zultra_tpu_torch.corpus import case_inputs, lz_data, mixed_corpus, random_bytes, text_corpus
from zultra_tpu_torch.ops import (
    block_torch,
    chain_cuda,
    dp_cuda,
    entropy_torch,
    histogram_cuda,
    matchlen_cuda,
    mk_cuda,
    plan_cuda,
    prefix_cuda,
    programs,
    rle_cuda,
    split_torch,
    suffix_cuda,
    suffix_torch,
    walk_cuda,
)
from zultra_tpu_torch.ops.entropy_torch import (
    MASK_ORDER,
    build_lengths,
    kraft_inputs,
    mask_search,
    mk_inputs,
    mk_lengths,
)
from zultra_tpu_torch.ops.matchfinder_torch import (
    HALO,
    SEG_CORE,
    SEG_LEN,
    build_segments,
    match_program,
    match_stacks,
    match_tables_device_stacked,
    salcp_batch,
    segments_from_corpus,
    upload_batch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _corpus(size=200_000):
    return np.frombuffer(mixed_corpus(size - 20000, seed=61)
                         + lz_data(20000, seed=62, alpha=4).tobytes(), np.uint8)


def test_walk_kernel_equals_plain(cuda):
    corpus = _corpus()
    segbufs, _ = build_segments(corpus, [(0, len(corpus))], SEG_CORE)
    salcp = salcp_batch(torch.from_numpy(segbufs[:3]).to(cuda))
    got = walk_cuda.walk_segments(salcp, HALO, SEG_CORE)
    torch.cuda.synchronize()
    want = walk_cuda.walk_segments_plain(salcp.cpu(), HALO, SEG_CORE)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["zero run", "period 3", "partial core", "odd n"])
def test_walk_kernel_equals_plain_edge(cuda, kind):
    """The walk's deep trees (a zero run nests intervals of LCP 3..258, a
    period-3 run as deep), a partial last core (its last chunk cut short),
    and four segments of an odd width, so that their words start on each
    of the four 4-byte offsets from the sweep's 16-byte staging."""
    n = HALO + SEG_CORE + 258
    halo, core = HALO, SEG_CORE
    if kind == "zero run":
        bufs = np.zeros((1, n), np.int32)
    elif kind == "period 3":
        bufs = np.resize(np.array([7, 7, 9], np.int32), (1, n))
    else:
        corpus = _corpus(100_000)
        if kind == "partial core":
            bufs = build_segments(corpus, [(0, len(corpus))], SEG_CORE)[0][1:2]
            core = SEG_CORE - 12345
        else:
            n, halo, core = 20001, 5000, 14000
            bufs = np.stack([256 + np.arange(n, dtype=np.int32) for _ in range(4)])
            for s in range(4):
                bufs[s, : n - 300] = corpus[s * 20000 :][: n - 300]
    salcp = salcp_batch(torch.from_numpy(bufs).to(cuda))
    got = walk_cuda.walk_segments(salcp, halo, core)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), walk_cuda.walk_segments_plain(salcp.cpu(), halo, core))
    for chunk in (1024, core):  # 32 chunks (the most) and one
        assert torch.equal(walk_cuda.walk_segments(salcp, halo, core, chunk), got)


def test_dp_and_chain_kernels_equal_plain(cuda):
    corpus = _corpus()
    mbs = 65536
    spans = [(0, mbs), (mbs, 2 * mbs)]
    lens, offs = match_tables_device_stacked(corpus, spans, mbs, cuda)
    n = 8192
    win = torch.from_numpy(np.stack([corpus[i * n : (i + 1) * n] for i in range(8)])).to(cuda)
    ml = lens[:, HALO:].reshape(16, n, 8)[:8].contiguous()
    mo = offs[:, HALO:].reshape(16, n, 8)[:8].contiguous()
    length = torch.tensor([n, n, n - 7, 5000, n, 1, n, n - 300], dtype=torch.int32, device=cuda)
    g_lit, g_off, tok = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    args = dp_cuda.prep_lanes(build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo,
                              length)
    got = dp_cuda.dp_choices(*args, length)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), dp_cuda.dp_choices_plain(*[a.cpu() for a in args]))

    step = torch.where(lens[:, :, 0] >= 3, lens[:, :, 0], 1).contiguous()
    start = torch.full((2,), HALO, dtype=torch.int32, device=cuda)
    n_real = torch.full((2,), HALO + mbs, dtype=torch.int32, device=cuda)
    marks = chain_cuda.chain_marks(step, start, n_real)
    torch.cuda.synchronize()
    assert torch.equal(marks.cpu(),
                       chain_cuda.chain_marks_plain(step.cpu(), start.cpu(), n_real.cpu()))
    assert bool(tok.any())


@pytest.mark.parametrize("seg,warm", [(dp_cuda.SEG, dp_cuda.WARM), (512, 512), (259, 0)])
def test_dp_segments_kernel_equals_model(cuda, seg, warm):
    """A lane with a 4 KiB zero run and ragged lengths (1, 511, 512, 513,
    past the last full segment, 0): the kernel's choices equal the
    sequential recurrence's, and its segment status equals the schedule
    model's, so the kernel re-ran exactly the segments the model did."""
    n = 8192
    d = bytearray(mixed_corpus(8 * n, seed=71)[: 8 * n])
    d[2048 : 2048 + 4096] = bytes(4096)
    corpus = np.frombuffer(bytes(d), np.uint8)
    lens, offs = match_tables_device_stacked(corpus, [(0, 8 * n)], 8 * n, cuda)
    win = torch.from_numpy(corpus.copy()).to(cuda).view(8, n)
    ml = lens[0, HALO : HALO + 8 * n].reshape(8, n, 8).contiguous()
    mo = offs[0, HALO : HALO + 8 * n].reshape(8, n, 8).contiguous()
    length = torch.tensor([n, 1, 511, 512, 513, 3 * 512 + 100, 0, n - 5], dtype=torch.int32,
                          device=cuda)
    g_lit, g_off, _ = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    args = dp_cuda.prep_lanes(build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo,
                              length)
    got, st = dp_cuda.dp_choices(*args, length, status=True, seg=seg, warm=warm)
    torch.cuda.synchronize()
    cpu = [a.cpu() for a in args]
    assert torch.equal(got.cpu(), dp_cuda.dp_choices_plain(*cpu))
    _, want_st = dp_cuda.dp_segments_model(*cpu, length.cpu(), seg, warm)
    assert torch.equal(st.cpu(), want_st)
    assert int(st.eq(dp_cuda.ST_RERUN).sum()) > 0


def _one_lane_dp_args(buf: np.ndarray, dev):
    """The DP's inputs for one lane of ``buf``: its match table on the
    card, code lengths from its greedy token histogram."""
    n = len(buf)
    lens, offs = match_tables_device_stacked(buf, [(0, n)], n, dev)
    win = torch.from_numpy(buf.copy()).to(dev)[None]
    ml = lens[:, HALO : HALO + n].contiguous()
    mo = offs[:, HALO : HALO + n].contiguous()
    length = torch.full((1,), n, dtype=torch.int32, device=dev)
    g_lit, g_off, _ = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    return (*dp_cuda.prep_lanes(build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo,
                                length), length)


@pytest.mark.parametrize("kind", ["text", "random"])
def test_dp_long_lane_equals_one_thread_form(cuda, kind):
    """A 2^21 lane (MAX_LANE, a 2 MiB block): the kernel's choices equal
    its one-thread form (one segment as long as the lane, run from the
    length by one thread), max abs err 0, and its segments run in
    parallel. Text costs some 2.6 bits a position, random bytes some 8,
    about 2^24 bits in all: no sum is clamped in either form."""
    buf = (np.frombuffer(text_corpus(1 << 21, 6), np.uint8) if kind == "text"
           else np.frombuffer(random_bytes(1 << 21, 6), np.uint8))
    args = _one_lane_dp_args(buf, cuda)
    got, st = dp_cuda.dp_choices(*args, status=True)
    one, one_st = dp_cuda.dp_choices(*args, status=True, seg=1 << 21)
    torch.cuda.synchronize()
    assert one_st.tolist() == [[dp_cuda.ST_EXACT]]
    assert int((got != one).sum()) == 0
    counts = collections.Counter(st.flatten().tolist())
    assert counts[dp_cuda.ST_EXACT] == 1 and counts[dp_cuda.ST_ANCHORED] > 1900, counts


@pytest.mark.parametrize("seg,warm", [(chain_cuda.SEG, chain_cuda.WARM), (100, 30)])
def test_chain_segments_kernel_equals_model(cuda, seg, warm):
    """Greedy steps of mixed data with a 16 KiB zero run, in lanes of
    ragged lengths (0, 1, seg - 1, seg, seg + 1, past the last full
    segment, n) and one start inside a segment, beside a lane whose steps
    are all 3; n is no multiple of 4, so lanes start off the 16-byte
    alignment of the bulk copies. The kernel's marks equal pointer
    doubling's, and its segment status equals the schedule model's, so it
    re-walked exactly the segments the model did."""
    n = 65536
    d = bytearray(mixed_corpus(n, seed=72)[:n])
    d[8192 : 8192 + 16384] = bytes(16384)
    lens, _ = match_tables_device_stacked(np.frombuffer(bytes(d), np.uint8), [(0, n)], n, cuda)
    rl = lens[0, HALO : HALO + n, 0]
    greedy = torch.nn.functional.pad(torch.where(rl >= 3, rl, 1), (0, 3), value=1)
    lengths = [n, 0, 1, seg - 1, seg, seg + 1, ((n - 1) // seg) * seg + 3, n + 3, n + 3]
    starts = [0] * 7 + [2 * seg + 37, 0]
    step = torch.stack([greedy] * 8 + [torch.full_like(greedy, 3)]).to(torch.int32).contiguous()
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got, st = chain_cuda.chain_marks(step, start, length, status=True, seg=seg, warm=warm)
    torch.cuda.synchronize()
    cpu = (step.cpu(), start.cpu(), length.cpu())
    assert torch.equal(got.cpu(), chain_cuda.chain_marks_plain(*cpu))
    _, want_st = chain_cuda.chain_segments_model(*cpu, seg, warm)
    assert torch.equal(st.cpu(), want_st)
    assert int(st.eq(chain_cuda.ST_UNMERGED).sum()) > 0


def _mk_batch(rng, B, S):
    """Weights from 1 to 2^20 on a random share of the symbols (some lanes
    empty or single-symbol), so MK gives codes far past the limit and
    Kraft repairs them; every 8th lane from the first is an edge lane in
    turn: all weights equal (every pick a tie), n_used 0, 1, 2, 3 and S."""
    w = (2 ** rng.integers(0, 21, (B, S))).astype(np.int32)
    h = np.where(rng.random((B, S)) < rng.random((B, 1)), w, 0).astype(np.int32)
    for b in range(0, B, 8):
        kind = (b // 8) % 6
        if kind == 0:
            h[b] = 9
        else:
            h[b] = 0
            used = {1: 0, 2: 1, 3: 2, 4: 3, 5: S}[kind]
            h[b, rng.permutation(S)[:used]] = rng.integers(1, 1000, used)
    return h


def _misaligned(x):
    """A contiguous copy of ``x`` whose base is 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return buf.view(x.shape).copy_(x)


@pytest.mark.parametrize("S", [19, 32, 288])
@pytest.mark.parametrize("B", [1, 31, 33, 4099])
def test_mk_and_kraft_kernels_equal_plain(cuda, S, B):
    """Both layouts of the MK kernel (a warp per lane, a thread per lane)
    and the Kraft kernel, on an aligned and a misaligned copy of the rows,
    equal the plain forms on skewed batches with edge lanes; Kraft at 7
    and 15 bits, and on a batch in which every lane fits (a copy)."""
    rng = np.random.default_rng(S * 10007 + B)
    hist = torch.from_numpy(_mk_batch(rng, B, S)).to(cuda)
    a0, n_used, _ = mk_inputs(hist)
    want = mk_cuda.mk_phase12_plain(a0.cpu(), n_used.cpu())
    assert torch.equal(mk_cuda.mk_phase12(a0, n_used).cpu(), want)
    for warp in (True, False):
        for rows in (a0, _misaligned(a0)):
            got = mk_cuda._launch_mk12(rows, n_used, warp)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (warp, rows.data_ptr() % 16)
    dense = torch.from_numpy(rng.integers(200, 400, (B, S)).astype(np.int32)).to(cuda)
    for h, max_len, fit in ((hist, 7, False), (hist, 15, False), (dense, 15, True)):
        lens, n_used, kraft0, _, _ = kraft_inputs(mk_lengths(h), max_len)
        full = 1 << max_len
        if fit:
            assert bool((kraft0 == full).all())
        elif B > 1:
            assert bool((kraft0 > full).any())
        want = mk_cuda.kraft_limit_plain(lens.cpu(), n_used.cpu(), kraft0.cpu(), max_len)
        for rows in (lens, _misaligned(lens)):
            got = mk_cuda.kraft_limit(rows, n_used, kraft0, max_len)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (max_len, rows.data_ptr() % 16)


TRACED_CALLS = 10


def _device_kernels(fn, kernel):
    """{name: launches} of the CUDA activities of TRACED_CALLS calls of
    ``fn`` in a trace. A trace may drop launches, never add them, so a
    count is at most the true one; a trace without ``kernel`` is taken
    again, up to five times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACED_CALLS):
                fn()
            torch.cuda.synchronize()
        names = collections.Counter(ev.name for ev in prof.events()
                                    if ev.device_type == torch.autograd.DeviceType.CUDA)
        if any(kernel in name for name in names):
            break
    return names


def _rle_rows(rng, B, L):
    """Histogram rows of runs, zeros and spikes; edge rows first: all
    zeros, eff 1, 3 and 4, one value to the end, a zero run of 5."""
    c = np.repeat(rng.integers(0, 12, (B, L)), rng.integers(1, 9, L), axis=1)[:, :L]
    c = np.where(rng.random((B, L)) < 0.15, 0, c) + np.where(rng.random((B, L)) < 0.05, 300, 0)
    c[:, rng.integers(L // 2, L + 1):] = 0
    edges = [np.zeros(L)] + [np.r_[np.full(e, 5), np.zeros(L - e)] for e in (1, 3, 4)]
    edges += [np.full(L, 7), np.r_[np.full(3, 9), np.zeros(5), np.full(L - 8, 9)]]
    for i, row in enumerate(edges[:B]):
        c[i] = row
    return torch.from_numpy(c.astype(np.int32))


@pytest.mark.parametrize("L", [19, 32, 288, 320])
@pytest.mark.parametrize("B", [1, 6, 84, 4099])
def test_rle_sweep_kernel_equals_plain(cuda, L, B):
    """The sweep kernel on an aligned and a misaligned copy equals the
    plain form; one launch a call, whatever L."""
    counts = _rle_rows(np.random.default_rng(L * 7 + B), B, L)
    want = rle_cuda.optimize_for_rle_plain(counts)
    for rows in (counts.to(cuda), _misaligned(counts.to(cuda))):
        ops.reset_launch_counts()
        got = rle_cuda.optimize_for_rle(rows)
        torch.cuda.synchronize()
        assert ops.launch_counts()["rle_sweep"] == 1
        assert torch.equal(got.cpu(), want), rows.data_ptr() % 16
    rows = counts.to(cuda)
    names = _device_kernels(lambda: rle_cuda.optimize_for_rle(rows), "rle_sweep_kernel")
    # the sweep kernel alone, at most once a call
    assert len(names) == 1 and "rle_sweep_kernel" in next(iter(names)), names
    assert sum(names.values()) <= TRACED_CALLS, names


@pytest.mark.parametrize("B", [1, 4, 128])
def test_rle_sweep_pair_kernel_equals_plain(cuda, B):
    """The planner's pair call (B rows of 288 and B of 32, the 4 MiB gzip
    run's shapes): one launch for both sets, each equal to the plain form;
    a trace shows the sweep kernel alone, once a call."""
    rng = np.random.default_rng(B + 3)
    lit, off = _rle_rows(rng, B, 288), _rle_rows(rng, B, 32)
    lit_d, off_d = lit.to(cuda), off.to(cuda)
    ops.reset_launch_counts()
    got = rle_cuda.optimize_for_rle_pair(lit_d, off_d)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rle_sweep"] == 1
    for g, rows in zip(got, (lit, off)):
        assert torch.equal(g.cpu(), rle_cuda.optimize_for_rle_plain(rows))
    names = _device_kernels(lambda: rle_cuda.optimize_for_rle_pair(lit_d, off_d),
                            "rle_sweep_kernel")
    assert len(names) == 1 and "rle_sweep_kernel" in next(iter(names)), names
    assert sum(names.values()) <= TRACED_CALLS, names


def _len_rows(rng, B, L):
    """Code-length rows: runs of 7, 8 and 9 of one length, zero runs
    around 3/11/138, lengths above 15, and seeded runs; n_def from 0 to L."""
    lens = np.repeat(rng.integers(0, 18, (B, L)), rng.integers(1, 12, L), axis=1)[:, :L]
    lens = np.where(rng.random((B, L)) < 0.2, 0, lens)
    for i, (v, k) in enumerate(((5, 7), (5, 8), (6, 9), (0, 11), (0, 139), (16, 4))[:B]):
        lens[i, :k] = v
        lens[i, k:k + 2] = 17
    n_def = rng.integers(0, L + 1, B)
    n_def[: min(B, 3)] = (0, 1, L)[: min(B, 3)]
    return torch.from_numpy(lens.astype(np.int32)), torch.from_numpy(n_def.astype(np.int32))


@pytest.mark.parametrize("L", [19, 32, 288, 320])
@pytest.mark.parametrize("B", [1, 40, 4096])
def test_rle_stats_kernel_equals_plain(cuda, L, B):
    """Both modes of the statistics kernel, every mask of MASK_ORDER in
    one launch, on aligned and misaligned rows, equal the plain forms."""
    rng = np.random.default_rng(L * 13 + B)
    lens, n_def = _len_rows(rng, B, L)
    te = torch.from_numpy(rng.integers(0, 8, (len(MASK_ORDER) * B, 19)).astype(np.int32))
    want_h = rle_cuda.rle_histogram_masks(lens, n_def, MASK_ORDER)
    want_b = rle_cuda.rle_bits_masks(lens, n_def, te, MASK_ORDER)
    nd, t = n_def.to(cuda), te.to(cuda)
    for rows in (lens.to(cuda), _misaligned(lens.to(cuda))):
        ops.reset_launch_counts()
        got_h = rle_cuda.rle_histogram_masks(rows, nd, MASK_ORDER)
        got_b = rle_cuda.rle_bits_masks(rows, nd, _misaligned(t), MASK_ORDER)
        torch.cuda.synchronize()
        assert ops.launch_counts()["rle_stats"] == 2
        assert torch.equal(got_h.cpu(), want_h) and torch.equal(got_b.cpu(), want_b)
    for mask in (7, 31):
        assert torch.equal(rle_cuda.rle_histogram_masks(lens.to(cuda), nd, (mask,)).cpu(),
                           rle_cuda.rle_histogram_plain(lens, n_def, mask))


def _table_rows(rng, B):
    """Code-length tables: lit rows whose last nonzero is below 257, at
    287, all zero; off rows all zero and full; runs of 3, 7, 11, 138, 139
    equal values; seeded rows."""
    lit = np.repeat(rng.integers(0, 16, (B, 288)), rng.integers(1, 12, 288), axis=1)[:, :288]
    lit = np.where(rng.random((B, 288)) < 0.3, 0, lit)
    off = np.where(rng.random((B, 32)) < 0.4, 0, rng.integers(1, 16, (B, 32)))
    edges = [(np.r_[np.full(100, 7), np.zeros(188)], np.zeros(32)),
             (np.r_[np.zeros(287), 9], np.full(32, 4)), (np.zeros(288), np.zeros(32))]
    for k in (3, 7, 11, 138, 139):
        edges.append((np.r_[np.full(2, 4), np.zeros(k), np.full(k, 8), np.zeros(288)][:288],
                      np.r_[np.full(k % 32, 5), np.zeros(32)][:32]))
    for i, (lr, orow) in enumerate(edges[:B]):
        lit[i], off[i] = lr, orow
    return (torch.from_numpy(lit.astype(np.int32)), torch.from_numpy(off.astype(np.int32)))


@pytest.mark.parametrize("B", [1, 8, 84, 4096])
def test_rle_stats_tables_kernel_equals_plain(cuda, B):
    """The fused statistics (the concatenation in the kernel) on aligned
    and misaligned tables, both modes, one mask and all 20, equal the plain
    form (n_lit and n_off too), one rle_stats launch a call; a trace of
    the calls shows the statistics kernels and nothing else (no
    concatenation ops)."""
    rng = np.random.default_rng(B)
    lit, off = _table_rows(rng, B)
    for masks in ((7,), (31,), MASK_ORDER):
        te = torch.from_numpy(rng.integers(0, 8, (len(masks) * B, 19)).astype(np.int32))
        want_h = rle_cuda.rle_histogram_tables(lit, off, masks)
        want_b = rle_cuda.rle_bits_tables(lit, off, te, masks)
        for rows in ((lit.to(cuda), off.to(cuda)), (_misaligned(lit.to(cuda)),
                                                    _misaligned(off.to(cuda)))):
            ops.reset_launch_counts()
            got_h = rle_cuda.rle_histogram_tables(*rows, masks)
            got_b = rle_cuda.rle_bits_tables(*rows, _misaligned(te.to(cuda)), masks)
            torch.cuda.synchronize()
            assert ops.launch_counts()["rle_stats"] == 2
            for g, w in zip(got_h, want_h):
                assert torch.equal(g.cpu(), w)
            assert torch.equal(got_b.cpu(), want_b)
        L, O, T = lit.to(cuda), off.to(cuda), te.to(cuda)
        names = _device_kernels(lambda: (rle_cuda.rle_histogram_tables(L, O, masks),
                                         rle_cuda.rle_bits_tables(L, O, T, masks)), "rle_stats")
        assert names and all("rle_stats" in n for n in names), names
        assert sum(names.values()) <= 2 * TRACED_CALLS, names


def test_rle_stats_long_n_def_equals_plain(cuda):
    """Rows already concatenated whose n_def passes their width (the last
    run reaches it): one mask packed (n_def < 2^PACK_BITS) or summed by
    __match_any_sync (n_def from 2^PACK_BITS), and all 20 masks, both
    modes, equal the plain form."""
    rng = np.random.default_rng(9)
    n_def = torch.tensor([1023, 1024, 5000, 1 << 20, 7, 320], dtype=torch.int32)
    lens, _ = _len_rows(rng, len(n_def), 320)
    lens[:, -40:] = 0
    for masks in ((7,), (31,), MASK_ORDER):
        te = torch.from_numpy(rng.integers(0, 8, (len(masks) * len(n_def), 19)).astype(np.int32))
        want_h = rle_cuda.rle_histogram_masks(lens, n_def, masks)
        want_b = rle_cuda.rle_bits_masks(lens, n_def, te, masks)
        L, N, T = lens.to(cuda), n_def.to(cuda), te.to(cuda)
        assert torch.equal(rle_cuda.rle_histogram_masks(L, N, masks).cpu(), want_h)
        assert torch.equal(rle_cuda.rle_bits_masks(L, N, T, masks).cpu(), want_b)


def test_mask_search_one_stats_launch_a_mode(cuda):
    """mask_search and dynamic_cost on the card equal their CPU forms, with
    one rle_stats launch for the histograms of all 20 masks and one for
    their bits, and one a mode for a dynamic cost."""
    rng = np.random.default_rng(5)
    lit = torch.from_numpy(np.where(rng.random((40, 288)) < 0.6,
                                    rng.integers(1, 3000, (40, 288)), 0).astype(np.int32))
    off = torch.from_numpy(np.where(rng.random((40, 32)) < 0.5,
                                    rng.integers(1, 300, (40, 32)), 0).astype(np.int32))
    ll, ol = build_lengths(lit, 15), build_lengths(off, 15)
    want = mask_search(ll, ol)
    ops.reset_launch_counts()
    got = mask_search(ll.to(cuda), ol.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["rle_stats"] == 2
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    ops.reset_launch_counts()
    got = entropy_torch.dynamic_cost(lit.to(cuda), off.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["rle_stats"] == 2
    assert torch.equal(got.cpu(), entropy_torch.dynamic_cost(lit, off))
    ll, ol = ll.to(cuda), ol.to(cuda)
    names = _device_kernels(lambda: mask_search(ll, ol), "rle_stats_masks_kernel")
    stats = sum(c for n, c in names.items() if "rle_stats_masks_kernel" in n)
    assert 1 <= stats <= 2 * TRACED_CALLS, names  # at most two a call


def _token_lanes(rng, W, n, n_tok):
    bucket = rng.integers(0, 18, (W, n))
    sym1 = rng.integers(0, 286, (W, n))
    sym2 = np.where(rng.random((W, n)) < 0.4, rng.integers(288, 318, (W, n)), 320)
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (bucket, sym1, sym2, np.asarray(n_tok))]


_CHUNK = 32768  # tokens a chunk of the kernel before tiles (a lane of many tiles)
_TILE = prefix_cuda.TILE


@pytest.mark.parametrize("n,n_tok", [
    (1 << 21, (1 << 21, 1_500_000, 2_000_000, 1234)),
    (8192, (0, 512, 8192)), (1000, (1000, 256, 999)),
    (2 * _CHUNK + 1000, (2 * _CHUNK + 1000, 2 * _CHUNK, _CHUNK, _CHUNK - 1, _CHUNK + 1)),
    (1 << 21, (203_000, 210_000, 190_000, 211_659)), (1 << 16, (13107,)),
    (3 * _TILE - 1, (3 * _TILE - 1, _TILE - 2, _TILE - 1, _TILE)),
    (2 * _TILE, (_TILE - 1, _TILE, _TILE + 1)), (2 * _TILE + 1, (0, 1, 2 * _TILE + 1))])
def test_prefix_tables_kernel_equals_plain(cuda, n, n_tok):
    """The prefix tables on the card (three kernel launches, one call)
    equal the plain form: the splitter's 4 x 2^21 lanes (full and with the
    gzip run's share of tokens), one 64 KiB window's lane, no token,
    tokens ending on a stride boundary, a lane not a multiple of 256, a
    lane of many tiles; tiles aligned in the flat row index with every
    lane starting one (n + 1 a multiple of the tile) or cut at the lanes'
    heads and tails (W = 3, n even and odd), tokens ending on, before and
    after a tile's rows; inputs aligned and misaligned."""
    args = _token_lanes(np.random.default_rng(n), len(n_tok), n, n_tok)
    want = prefix_cuda.prefix_tables_plain(*args)
    dev_args = [a.to(cuda) for a in args]
    for first in (dev_args[0], _misaligned(dev_args[0])):
        ops.reset_launch_counts()
        got = prefix_cuda.prefix_tables(first, *dev_args[1:])
        torch.cuda.synchronize()
        assert ops.launch_counts()["prefix_tables"] == 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    names = _device_kernels(lambda: prefix_cuda.prefix_tables(*dev_args),
                            "prefix_tables_")
    # the count, scan and write kernels and nothing else, each at most once a call
    phases = ("count", "scan", "write")
    assert sorted(k for k in phases for n in names
                  if f"prefix_tables_{k}_kernel" in n) == sorted(phases), names
    assert len(names) == 3 and max(names.values()) <= TRACED_CALLS, names


def test_split_batch_builds_no_one_hot(cuda, monkeypatch):
    """split_batch on the card takes the prefix kernels, never the plain
    form (its one-hot and cumsums), and equals its CPU form."""
    corpus = _corpus(70_000)
    n = split_torch.split_bucket(len(corpus))
    win = np.zeros((1, n), np.uint8)
    win[0, : len(corpus)] = corpus
    from zultra_tpu import native

    table = native.build_match_table(np.ascontiguousarray(corpus), 0).astype(np.int32)
    rl = np.zeros((1, n), np.int32)
    ro = np.zeros((1, n), np.int32)
    rl[0, : len(corpus)], ro[0, : len(corpus)] = table[:, 0, 0], table[:, 0, 1]
    args = [torch.from_numpy(a) for a in (win, rl, ro)]
    n_real = torch.tensor([len(corpus)], dtype=torch.int32)
    cap = split_torch.input_cap(len(corpus))
    want = split_torch.split_batch(*args, 0, n_real, cap, 0)

    def refuse(*a):
        raise AssertionError("the plain prefix tables ran on the card's path")

    monkeypatch.setattr(prefix_cuda, "prefix_tables_plain", refuse)
    ops.reset_launch_counts()
    got = split_torch.split_batch(*[a.to(cuda) for a in args], 0, n_real.to(cuda), cap, 0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["prefix_tables"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_one_shot_equals_native(cuda):
    engine.set_engine("native")
    try:
        data = _corpus(300_000).tobytes()
        for flags, mbs in ((2, 0), (0, 65536), (1, 32768)):
            got = compress(data, flags, mbs, device=cuda)
            assert got == zt.compress(data, flags, mbs)
        assert zlib.decompress(compress(data, 2, device=cuda), 31) == data
    finally:
        engine._active_engine = None


def test_many_windows_and_largest_block_equal_native(cuda):
    """20 windows of 32 KiB cross the 16-window device batch; a 2 MiB
    block size (the largest legal) gives a 2^21-position DP lane."""
    engine.set_engine("native")
    try:
        data = _corpus(20 * 32768 - 5000).tobytes()
        assert compress(data, 1, 32768, device=cuda) == zt.compress(data, 1, 32768)
        big = _corpus(2_200_000).tobytes()
        assert compress(big, 0, 2 << 20, device=cuda) == zt.compress(big, 0, 2 << 20)
    finally:
        engine._active_engine = None


def test_matchlen_kernel_equals_plain(cuda):
    """Random pairs over binary data (long matches), pos == prev, pairs
    near and past the end, and a 300-byte run; P is no multiple of 8.
    Then ``matchlen_cuda.edge_pairs`` (every p, q mod 16; lengths K - 1,
    K and K + 1 of the head width K; 258 and the 259 cap; spans to the
    end; negative and out-of-range indices) at every base offset 0-15,
    the data ending at the end of its allocation, against the plain form
    and the schedule's model."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2, 100_003, dtype=np.uint8)
    data[5000:5300] = 9
    n = len(data)
    pos = np.concatenate([rng.integers(0, n, 20001), np.arange(5001, 5300), [n - 1, n, n + 7],
                          rng.integers(n - 258, n, 500)])
    prev = np.concatenate([rng.integers(0, n, 20001), np.arange(5000, 5299), [n - 1, 0, 3],
                           rng.integers(n - 600, n, 500)])
    args = [torch.from_numpy(a).to(cuda) for a in
            (data, pos.astype(np.int32), prev.astype(np.int32))]
    got = matchlen_cuda.match_lengths(*args)
    torch.cuda.synchronize()
    want = matchlen_cuda.match_lengths_plain(*[a.cpu() for a in args])
    assert torch.equal(got.cpu(), want)
    assert int(want.max()) == 258

    e_data, e_pos, e_prev = matchlen_cuda.edge_pairs()
    e_args = [torch.from_numpy(a) for a in (e_data, e_pos, e_prev)]
    e_want = matchlen_cuda.match_lengths_plain(*e_args)
    assert int((e_want == 258).sum()) > 64
    pos_d, prev_d = e_args[1].to(cuda), e_args[2].to(cuda)
    for off in range(16):
        buf = torch.empty(off + len(e_data), dtype=torch.uint8, device=cuda)
        x = buf[off:]
        x.copy_(e_args[0].to(cuda))
        got = matchlen_cuda.match_lengths(x, pos_d, prev_d)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), e_want), off
        model, _ = matchlen_cuda.match_lengths_model(*e_args, x.data_ptr() % 16)
        assert torch.equal(model, e_want)


HIST_CASES = [(1, 0, 256), (15, 1, 256), (4097, 3, 200), (1_000_003, 5, 300), (40 << 20, 0, 256)]
HIST_CASES += [(n, off, 256) for n in (0, 1, 15, 16, 17) for off in (0, 7)]
HIST_CASES += [(n, off, n_sym) for n in (16383, 16384, 16385)
               for off, n_sym in ((0, 256), (9, 255))]
HIST_CASES += [(70_001, off, n_sym) for off in range(16) for n_sym in (1, 255, 256, 257, 300)
               if off % 5 == n_sym % 5]
HIST_CASES += [(64 << 20, 0, 256, "one value")]


@pytest.mark.parametrize("case", HIST_CASES, ids=lambda c: "-".join(map(str, c)))
def test_hist_kernel_equals_plain_and_bincount(cuda, case):
    """Unaligned views (the kernel's byte-wise head and tail) at offsets
    0-15, n = 0, 1, 15, 16, 17 and one block step (16384 bytes) +- 1,
    n_symbols 1, 255, 256, 257 and 300, 40 MiB (past the TPU kernel's
    2^24 chunk), and 64 MiB of one byte value (every count on one bin).
    One call is one kernel launch."""
    n, offset, n_symbols, *kind = case
    rng = np.random.default_rng(n + offset)
    if kind:
        buf = torch.full((n + offset,), 211, dtype=torch.uint8, device=cuda)
    else:
        buf = torch.from_numpy(rng.integers(0, 256, n + offset, dtype=np.uint8)).to(cuda)
    x = buf[offset:]
    before = ops.launch_counts()["hist"]
    got = histogram_cuda.byte_histogram(x, n_symbols)
    assert ops.launch_counts()["hist"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (n_symbols,)
    assert torch.equal(got.cpu(), histogram_cuda.byte_histogram_plain(x.cpu(), n_symbols))
    ref = torch.bincount(x, minlength=256)[:n_symbols]
    assert torch.equal(got[: ref.numel()], ref)
    assert int(got.sum()) == int((x.to(torch.int64) < n_symbols).sum())
    if kind:
        assert int(got[211]) == n
    if n <= 1 << 20:
        grid = histogram_cuda.grid_for(histogram_cuda.split(n, x.data_ptr())[1], 1 << 30)
        model, _ = histogram_cuda.byte_histogram_model(x.cpu(), n_symbols, min(grid, 64),
                                                       x.data_ptr() % 16)
        assert torch.equal(model, got.cpu())


def test_hist_one_kernel_per_call(cuda):
    """A traced histogram call runs its one kernel on the card and
    nothing else: no memset, no copy."""
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, 4 << 20, np.uint8)).to(cuda)
    histogram_cuda.byte_histogram(x[3:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            histogram_cuda.byte_histogram(x[3:])
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("hist_kernel" in name for name in names), names


def test_stream_equals_native(cuda):
    """Twenty 32 KiB windows streamed in 16 KiB chunks: two device
    batches (16 + 4)."""
    engine.set_engine("native")
    try:
        data = _corpus(20 * 32768 - 5000).tobytes()
        stream = Stream(1, 32768, device=cuda)
        out = b"".join(stream.compress(data[i : i + 16384]) for i in range(0, len(data), 16384))
        out += stream.compress(b"", FINALIZE)
        assert out == zt.compress(data, 1, 32768)
    finally:
        engine._active_engine = None


def test_begin_window_equals_plain(cuda):
    """A window planned alone on the card: the same blocks and plans as on
    the CPU (plain forms), and a per-window stream equal to the native
    engine's."""
    from zultra_tpu_torch import DeviceWindowEngine, begin_window_device

    data = _corpus(3 * 32768 - 700)
    got = begin_window_device(data[: 32768 + 20000], 32768, 20000, device=cuda)
    want = begin_window_device(data[: 32768 + 20000], 32768, 20000, device="cpu")
    assert got.block_spans == want.block_spans
    for p, q in zip(got.plans, want.plans):
        for key in q:
            np.testing.assert_array_equal(np.asarray(p[key]), np.asarray(q[key]), err_msg=key)
    engine_c = DeviceWindowEngine(cuda)
    table = engine_c.find_all_matches(data[:40000], 8000, 40000)
    from zultra_tpu.matchfinder import find_all_matches

    np.testing.assert_array_equal(table, find_all_matches(data[:40000].copy(), 8000, 40000))


def test_devices_and_windows_per_batch_equal_native(cuda):
    from zultra_tpu_torch import compress_device

    engine.set_engine("native")
    try:
        data = _corpus(5 * 32768 + 999).tobytes()
        want = zt.compress(data, 2, 32768)
        n = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0", "cuda:0"]
        assert compress_device(data, 2, 32768, windows_per_batch=1, devices=devices) == want
        assert compress_device(data, 2, 32768, windows_per_batch=2, device=cuda) == want
    finally:
        engine._active_engine = None


def test_one_window_lane_follows_its_input_on_the_card(cuda):
    """A 48,944-byte gzip input at 1 MiB blocks: each call plans one batch
    at a lane of two segments, gives the CPU form's bytes, and from the
    third call on replays every program, the match program at (W, k) =
    (1, 2), with no new capture and no eager call."""
    from zultra_tpu_torch import compress_device, profiling

    data = mixed_corpus(48944, seed=98)
    want = compress_device(data, 2, 1 << 20, device="cpu")
    profiling.reset()
    for call in range(4):
        profiling.enable()
        try:
            got = compress_device(data, 2, 1 << 20, device=cuda)
        finally:
            profiling.enable(False)
        c = profiling.report(reset=True)["counters"]
        assert got == want, call
        assert c["lane.narrowed"] == 1 and c["match.positions"] == 2 * SEG_CORE, (call, c)
        if call >= 2:
            assert c.get("program.capture", 0) == 0 and c.get("program.eager", 0) == 0, (call, c)
            assert c["program.replay"] >= 3, (call, c)  # match, split and the planner's buckets
    statics = [dict(p["key"][2]) for p in programs.captured(cuda) if p["key"][0] is match_program]
    assert {"W": 1, "k": 2} in statics, statics


def test_windows_distributed_gloo_on_one_card(cuda, tmp_path):
    """Two gloo ranks spawned on cuda:0: rank 0's stream equals the native
    engine's, and both ranks launched the compression kernels."""
    from zultra_tpu_torch.parallel import multihost

    engine.set_engine("native")
    try:
        data = _corpus(3 * 32768 + 4321).tobytes()
        out, stats = multihost.run_windows_distributed(
            data, 1, 32768, world_size=2, device="cuda:0",
            init_method=f"file://{tmp_path / 'rendezvous'}", timeout=300)
        assert out == zt.compress(data, 1, 32768)
        for st in stats:
            assert all(st["launches"][k] > 0 for k in ("walk", "dp", "chain", "mk12", "kraft",
                                                        "rle_sweep", "rle_stats", "prefix_tables"))
    finally:
        engine._active_engine = None


def test_sharded_corpus_stats_on_the_card(cuda):
    """The statistics on the card equal the CPU's, their histogram comes
    from the histogram kernel, and the Adler partials fold to zlib's."""
    from zultra_tpu_torch.ops import checksum
    from zultra_tpu_torch.parallel import sharded_corpus_stats

    data = _corpus(5 * 65536 + 77).tobytes()
    ops.reset_launch_counts()
    got = sharded_corpus_stats(data, devices=[cuda, cuda])
    assert ops.launch_counts()["hist"] == 2
    want = sharded_corpus_stats(data, devices=["cpu", "cpu"])
    assert got["n_windows"] == want["n_windows"] == 6
    for key in ("suffix_arrays", "ranks"):
        assert torch.equal(got[key].cpu(), want[key]), key
    for key in ("corpus_histogram", "adler_s1", "adler_s2"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert checksum.adler32(data, device=cuda) == zlib.adler32(data)


def test_write_tokens_on_the_card(cuda):
    """Token emission on the card (chain kernel token starts, the emission
    kernel with the encoders' tables cut to 288 and 32 symbols) equals its
    CPU form on a parse from the native optimal parser."""
    from zultra_tpu import native
    from zultra_tpu.constants import (
        NLITERALSYMS,
        NOFFSETSYMS,
        static_literal_code_lengths,
        static_offset_code_lengths,
    )
    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu_torch.ops.emit_torch import write_tokens

    data = np.ascontiguousarray(_corpus(60000))
    table = native.build_match_table(data, 5000)
    lit = HuffmanEncoder(NLITERALSYMS, 15)
    off = HuffmanEncoder(NOFFSETSYMS, 15)
    lit.code_length[:NLITERALSYMS] = [int(x) for x in static_literal_code_lengths()]
    off.code_length[:NOFFSETSYMS] = [int(x) for x in static_offset_code_lengths()]
    lit.build_static_codewords()
    off.build_static_codewords()
    slit = np.zeros(NLITERALSYMS, np.int32)
    slit[: len(static_literal_code_lengths())] = static_literal_code_lengths()
    best = native.optimize_matches(slit, np.asarray(static_offset_code_lengths(), np.int32),
                                   data, table, 5000, len(data)).astype(np.int32)
    ops.reset_launch_counts()
    got = write_tokens(data, best, 5000, len(data), lit, off, device=cuda)
    assert ops.launch_counts()["chain"] == 1 and ops.launch_counts()["emit_tokens"] == 1
    assert got == write_tokens(data, best, 5000, len(data), lit, off, device="cpu")


# ---------------------------------------------------------------------------
# The planner and the splitter as programs (ops/programs.py)
# ---------------------------------------------------------------------------

GOLDEN = Path(__file__).resolve().parent.parent / "zultra_tpu_torch" / "smoke_golden.json"


def _golden_cases() -> dict:
    return {c["name"]: c for c in json.loads(GOLDEN.read_text())["cases"]}


def _assert_golden(label, case, out):
    assert (len(out), hashlib.sha256(out).hexdigest()) == (case["out_len"], case["out_sha256"]), \
        label


def _per_window(case, data, dictionary, device):
    """Every window planned alone (``DeviceWindowEngine.begin_window``) and
    emitted in stream order, framed as compress_device frames it."""
    from zultra_tpu_torch import frame
    from zultra_tpu_torch.stream import clamp_block_size, memory_bound

    eng = DeviceWindowEngine(device)
    mbs = clamp_block_size(case["block_size"])
    flags = case["flags"]
    corpus = np.frombuffer((dictionary or b"") + data, np.uint8)
    base = len(dictionary or b"")
    out = bytearray(frame.encode_header(flags, dictionary))
    buf = bytearray(memory_bound(mbs, flags, mbs))
    bits_data = bits_count = 0
    spans = [(base + lo, base + min(lo + mbs, len(data))) for lo in range(0, len(data), mbs)]
    for i, (lo, hi) in enumerate(spans):
        prev = min(32768, lo)
        handle = eng.begin_window(corpus[lo - prev : hi], prev, hi - lo)
        n, bits_data, bits_count = eng.emit_window(handle, i + 1 == len(spans), buf, bits_data,
                                                   bits_count)
        out += buf[:n]
    out += frame.encode_footer(flags, frame.update_checksum(frame.init_checksum(flags),
                                                            corpus[base:], flags), len(data))
    return bytes(out)


def test_programs_replay_equals_eager_on_the_gzip_case(cuda):
    """The gzip case's planner and splitter programs: each replay (under
    set_sync_debug_mode("error")) equals an eager call of its function on
    the same inputs, every output. The first run meets every shape (eager,
    unless an earlier test met it), the second captures, the third
    captures nothing new; all three launch the same."""
    case = _golden_cases()["gzip"]
    data, _ = case_inputs(case)
    counts, keys = [], []
    for run in ("first", "second", "third"):
        ops.reset_launch_counts()
        _assert_golden(f"{run} run", case, compress(data, case["flags"], device=cuda))
        counts.append(ops.launch_counts())
        keys.append({p["key"] for p in programs.captured(cuda)})
    assert counts[0] == counts[1] == counts[2]
    assert keys[1] == keys[2]
    rows = programs.replay_against_eager(cuda)
    assert {"plan_block_core", "split_program"} <= {r["key"][0].__name__ for r in rows}
    assert all(r["launches"] for r in rows), rows
    assert [r["key"] for r in rows if r["max_abs_err"]] == []


def test_program_calls_make_no_host_sync(cuda):
    """A planner bucket and a splitter batch already captured: the lane
    gather, the input copies, replays and output copies under
    set_sync_debug_mode("error")."""
    corpus = _corpus(70_000)
    mbs = 32768
    spans = [(0, mbs), (mbs, 2 * mbs)]
    lens, offs = match_tables_device_stacked(corpus, spans, mbs, cuda)
    win = np.zeros((2, HALO + mbs), np.uint8)
    win[0, HALO:] = corpus[:mbs]
    win[1] = corpus[: 2 * mbs]
    win = torch.from_numpy(win).to(cuda)
    n = split_torch.split_bucket(HALO + mbs)
    pad = (0, n - HALO - mbs)
    split_args = (torch.nn.functional.pad(win, pad), torch.nn.functional.pad(lens[:, :, 0], pad),
                  torch.nn.functional.pad(offs[:, :, 0], pad), HALO,
                  torch.full((2,), HALO + mbs, dtype=torch.int32, device=cuda), 32768, 64)
    tok = split_torch.split_batch(*split_args)[2][:, : HALO + mbs]
    meta = torch.tensor([[0, 1, 1], [HALO, HALO, HALO + 9000], [9000, 9000, 20000]],
                        dtype=torch.int64, device=cuda)
    meta = torch.cat([meta, torch.zeros((3, 1), dtype=torch.int64, device=cuda)], dim=1)
    split_torch.split_batch(*split_args)  # the second call: captured
    bucket = block_torch.slice_bucket(win, lens, offs, meta, tok, 32768)
    want = programs.run(block_torch.plan_block_core, *bucket)  # eager
    programs.run(block_torch.plan_block_core, *bucket)  # captured
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_split = split_torch.split_batch(*split_args)
        bucket = block_torch.slice_bucket(win, lens, offs, meta, tok, 32768)
        got = programs.run(block_torch.plan_block_core, *bucket)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got_split[2][:, : HALO + mbs], tok)


@pytest.mark.parametrize("path", ["one-shot", "Stream", "per window", "devices"])
def test_every_golden_digest_through_the_programs(cuda, path):
    """Every case of smoke_golden.json through the graph path, byte for byte
    the native engine's output (its recorded digest)."""
    for name, case in _golden_cases().items():
        data, dictionary = case_inputs(case)
        if path == "one-shot":
            out = compress(data, case["flags"], case["block_size"], dictionary, device=cuda)
        elif path == "Stream":
            stream = Stream(case["flags"], case["block_size"], device=cuda)
            if dictionary:
                stream.set_dictionary(dictionary)
            out = b"".join(stream.compress(data[i : i + 16384])
                           for i in range(0, len(data), 16384))
            out += stream.compress(b"", FINALIZE)
        elif path == "per window":
            out = _per_window(case, data, dictionary, cuda)
        else:
            from zultra_tpu_torch import compress_device

            out = compress_device(data, case["flags"], case["block_size"], dictionary,
                                  devices=["cuda:0", "cuda:0"])
        _assert_golden(f"{name} {path}", case, out)


def test_text_at_2m_blocks_runs_its_long_lanes_in_parallel(cuda):
    """The golden text case at zultra's largest block size: two windows,
    each holding one block past 2^20 positions (4,191,288 of the
    4,194,304 bytes in the two; the tracer's dp.long_* counters); the
    bytes are the golden digest."""
    case = _golden_cases()["text2m"]
    data, _ = case_inputs(case)
    compress(data, case["flags"], case["block_size"], device=cuda)  # eager, then the counts
    profiling.reset()
    profiling.enable()
    try:
        out = compress(data, case["flags"], case["block_size"], device=cuda)
    finally:
        profiling.enable(False)
    c = profiling.report(reset=True)["counters"]
    _assert_golden("text2m", case, out)
    assert c["plan.input"] == len(data) and c["dp.long_lanes"] == 2, c
    assert 0.99 * len(data) < c["dp.long_positions"] < len(data), c


def test_padded_zero_length_lanes_on_the_card(cuda):
    """A bucket of 3 lanes planned at 4 on the card equals its CPU plans;
    lanes of length 0 go through every kernel of the planner (DP, chain, MK,
    Kraft, the RLE sweep and statistics) and plan what the plain forms
    plan."""
    corpus = _corpus(70_000)
    mbs = 32768
    spans = [(0, mbs), (mbs, 2 * mbs)]
    lens, offs = match_tables_device_stacked(corpus, spans, mbs, "cpu")
    win = np.zeros((2, HALO + mbs), np.uint8)
    win[0, HALO:] = corpus[:mbs]
    win[1] = corpus[: 2 * mbs]
    win = torch.from_numpy(win)
    lanes = [(0, HALO, 3000), (1, HALO + 100, 4000), (1, HALO + 5000, 2500)]
    got = block_torch.plan_blocks_device_multi(win.to(cuda), lens.to(cuda), offs.to(cuda), lanes)
    want = block_torch.plan_blocks_device_multi(win, lens, offs, lanes)
    for p, q in zip(got, want):
        for key in q:
            np.testing.assert_array_equal(np.asarray(p[key]), np.asarray(q[key]), err_msg=key)

    n = block_torch.TILE
    length = torch.tensor([0, 3000, 0, 0], dtype=torch.int32)
    args = (win[:, HALO : HALO + n].repeat(2, 1), lens[:, HALO : HALO + n].repeat(2, 1, 1),
            offs[:, HALO : HALO + n].repeat(2, 1, 1), length)
    ops.reset_launch_counts()
    out = block_torch.plan_block_core(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("dp", "chain", "mk12", "kraft", "rle_sweep",
                                        "rle_stats", "prep_lanes", "token_hist",
                                        "emit_tokens", "lex_order")), counts
    assert counts["rle_sweep"] == 1 and counts["emit_tokens"] == 1, counts
    plain = block_torch.plan_block_core(*args)
    for key in plain:
        assert torch.equal(out[key].cpu(), plain[key]), key


def test_match_program_replay_equals_eager_and_cpu(cuda):
    """Two 64 KiB windows, the second a zero run (its segments need all
    17 doubling rounds): three calls on the card (eager, captured, replayed;
    the last under set_sync_debug_mode("error"), the upload's pinned copies
    included) each equal the CPU form, window bytes too; the replay equals
    an eager call of the program on the same inputs."""
    mbs = 65536
    corpus = np.concatenate([np.frombuffer(mixed_corpus(mbs, seed=81), np.uint8),
                             np.zeros(mbs, np.uint8)])
    spans = [(0, mbs), (mbs, 2 * mbs)]
    want = match_stacks(corpus, spans, mbs, "cpu")
    assert int((want[0][1, HALO:, 0] >= 3).sum()) > mbs - 300
    for call in range(3):
        torch.cuda.synchronize()
        if call == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = match_stacks(corpus, spans, mbs, cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), call
    rows = programs.replay_against_eager(cuda, fn=match_program)
    keys = [r["key"] for r in rows if dict(r["key"][2]) == {"W": 2, "k": 2}]
    assert len(keys) == 1
    assert all(r["max_abs_err"] == 0 and r["launches"] == {"walk": 1, "suffix_round": 17}
               for r in rows), rows


# ---------------------------------------------------------------------------
# The doubling round (csrc/suffix.cu)
# ---------------------------------------------------------------------------

def _match_segments(content: str, W: int, mbs: int, dev, seed: int = 0) -> torch.Tensor:
    """A batch's segments as the match program cuts them."""
    make = mixed_corpus if content == "mixed" else text_corpus
    corpus = np.frombuffer(make(W * mbs, seed=seed), np.uint8)
    spans = [(i * mbs, (i + 1) * mbs) for i in range(W)]
    corpus_dev, meta, W, k = upload_batch(corpus, spans, mbs, dev)
    return segments_from_corpus(corpus_dev, meta[: W * k], SEG_LEN)


def _plain_doubling(bufs: torch.Tensor, store: int = 8):
    """The plain rounds on the card: (sa, stored ranks, rounds run as the
    kernel counts them, the round after which each segment was distinct)."""
    rank, rows, first = bufs.to(torch.int32), [bufs.to(torch.int32)], None
    levels = suffix_torch.num_levels(bufs.shape[1])
    run = torch.zeros(bufs.shape[0], dtype=torch.int32, device=bufs.device)
    distinct = torch.zeros(bufs.shape[0], dtype=torch.bool, device=bufs.device)
    for level in range(levels):
        run += (~distinct).to(torch.int32)
        sa, rank, distinct = suffix_torch._round(rank, 1 << level)
        if level < store:
            rows.append(rank)
    return sa, torch.stack(rows), run


@pytest.mark.parametrize("content,W,mbs", [("mixed", 16, 1 << 20), ("text", 16, 2 << 20),
                                           ("text", 1, 48944)],
                         ids=["mixed100m 512", "text32m 1024", "files48k 2"])
def test_suffix_round_kernel_equals_plain_at_the_cells_shapes(cuda, content, W, mbs):
    """The kernel's doubling (17 launches, 8 stored levels) on a batch of
    each cell's shape equals the plain rounds: the suffix order, the 9
    stored rank tables (a skipped segment's identity rows among them), the
    rounds each segment ran; and the early exit equals the fixed form."""
    bufs = _match_segments(content, W, mbs, cuda)
    assert bufs.shape[1] == SEG_LEN
    ops.reset_launch_counts()
    got = suffix_torch.doubling_rounds_fixed(bufs, store_levels=8)
    assert ops.launch_counts()["suffix_round"] == 17
    want = _plain_doubling(bufs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[2].max()) < 17  # every segment skips rounds
    early = suffix_torch.doubling_rounds(bufs, store_levels=8)
    for g, w in zip(early, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["zero run", "random", "sentinels", "corpus windows"])
def test_suffix_round_kernel_equals_model(cuda, kind):
    """The zero run's segments (a large group every round, all 17 rounds
    on the zeros), a random segment, an all-sentinel one and zero-padded
    byte rows of 65,536 (the corpus statistics'): the kernel's doubling
    with every level stored equals the plain rounds and the model's,
    rounds run included."""
    if kind == "zero run":
        raw = mixed_corpus(8000, seed=3) + bytes(3 << 15) + mixed_corpus(24000, seed=4)
        bufs, _ = build_segments(np.frombuffer(raw, np.uint8), [(0, len(raw))], SEG_CORE)
        rows = torch.from_numpy(bufs[:4])
    elif kind == "random":
        raw = random_bytes(2 * SEG_CORE, seed=7)
        bufs, _ = build_segments(np.frombuffer(raw, np.uint8), [(0, len(raw))], SEG_CORE)
        rows = torch.from_numpy(bufs[:1])
    elif kind == "sentinels":
        rows = (256 + torch.arange(SEG_LEN, dtype=torch.int32))[None]
    else:
        host = np.zeros((2, 1 << 16), np.uint8)
        host[0] = np.frombuffer(text_corpus(1 << 16, seed=8), np.uint8)
        host[1, :40000] = np.frombuffer(mixed_corpus(40000, seed=9), np.uint8)
        rows = torch.from_numpy(host.astype(np.int32))
    sa, ranks, run = suffix_torch.doubling_rounds_fixed(rows.to(cuda))
    sa_m, ranks_m, _, run_m = suffix_cuda.doubling_model(rows)
    assert torch.equal(sa.cpu(), sa_m) and torch.equal(ranks.cpu(), ranks_m)
    assert torch.equal(run.cpu(), run_m)
    want = _plain_doubling(rows.to(cuda), store=ranks.shape[0] - 1)
    assert torch.equal(sa, want[0]) and torch.equal(ranks, want[1])


def test_suffix_round_kernel_rows_past_its_cap_take_the_plain_round(cuda):
    """A row longer than the kernel takes goes through the plain round on
    the card, counted by the tracer; its results equal the CPU's."""
    from zultra_tpu_torch import profiling

    n = suffix_cuda.MAX_N + 5
    rows = torch.from_numpy(np.frombuffer(text_corpus(n, seed=12), np.uint8)
                            .astype(np.int32))[None]
    ops.reset_launch_counts()
    profiling.reset()
    profiling.enable()
    try:
        got = suffix_torch.doubling_rounds(rows.to(cuda))
    finally:
        profiling.enable(False)
    assert ops.launch_counts()["suffix_round"] == 0
    assert profiling.report(reset=True)["counters"]["suffix.plain_rounds"] >= 1
    want = suffix_torch.doubling_rounds(rows)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_match_program_sorts_nothing_and_a_compression_launches_the_round(cuda, monkeypatch):
    """The match program calls no torch.sort on the card, and a gzip
    compression launches the doubling kernel."""
    corpus = _corpus(70_000)
    spans = [(0, 32768), (32768, 65536)]
    corpus_dev, meta, W, k = upload_batch(corpus, spans, 32768, cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.sort called in the match program")

    with monkeypatch.context() as m:
        m.setattr(torch, "sort", refuse)
        out = match_program(corpus_dev, meta, W=W, k=k)
    want = match_program(corpus_dev.cpu(), meta.cpu(), W=W, k=k)
    for g, w in zip(out, want):
        assert torch.equal(g.cpu(), w)
    ops.reset_launch_counts()
    compress(bytes(corpus), 2, device=cuda)
    assert ops.launch_counts()["suffix_round"] > 0


# ---------------------------------------------------------------------------
# The planner's fused passes (csrc/plan.cu): K11-K14
# ---------------------------------------------------------------------------

# The planner's bucket shapes (lanes, positions) of the 4 MiB gzip case.
GZIP_BUCKETS = [(128, 32768), (4, 65536), (1, 131072), (4, 262144), (2, 524288), (2, 1048576)]


def _planner_inputs(B, n, seed, dev):
    """Seeded planner lanes on the card: window bytes, match tables (B, n,
    8) of mostly short matches (some of 258, offsets 1, 256, 257 and
    32768 among them), lengths (the first lane full, the last 0 where B >
    1, the rest seeded), token marks of the first row's chain, and code
    tables (lengths 1-15, codewords below 2^length)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=dtype)

    window = ints(0, 256, (B, n), torch.uint8)
    u = torch.rand((B, n, 8), generator=g, device=dev)
    mlens = torch.where(u < 0.15, ints(3, 40, (B, n, 8)),
                        torch.where(u > 0.995, 258, 0)).to(torch.int32)
    moffs = torch.where(mlens >= 3, ints(1, 32769, (B, n, 8)), 0).to(torch.int32)
    edge = torch.tensor([1, 256, 257, 32768], dtype=torch.int32, device=dev)
    moffs[:, ::97, :4] = torch.where(mlens[:, ::97, :4] >= 3, edge, 0)
    length = torch.from_numpy(rng.integers(n // 2, n + 1, B).astype(np.int32)).to(dev)
    length[0] = n
    if B > 1:
        length[-1] = 0
    is_tok = chain_cuda.chain_marks(torch.where(mlens[:, :, 0] >= 3, mlens[:, :, 0], 1),
                                    torch.zeros_like(length), length)
    lit_len, off_len = ints(1, 16, (B, 288)), ints(1, 16, (B, 32))
    lit_cw = ints(0, 1 << 15, (B, 288)) & ((1 << lit_len) - 1)
    off_cw = ints(0, 1 << 15, (B, 32)) & ((1 << off_len) - 1)
    return window, mlens, moffs, length, is_tok, (lit_cw, lit_len, off_cw, off_len)


def _same(got, want, label):
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, i)
        assert torch.equal(g, w), (label, i, int((g.to(torch.int64) - w.to(torch.int64))
                                              .abs().max()))


@pytest.mark.parametrize("B,n", GZIP_BUCKETS)
def test_planner_fused_kernels_equal_plain(cuda, B, n):
    """prep_lanes, token_hist (given marks: the chain's, and the first
    row's strided view as the greedy call passes it) and emit_tokens at a
    gzip bucket shape, and token_hist on a zero-run lane and a one-byte
    lane of the bucket's width (contiguous rows and the stride-8 first
    slot): each launch's outputs equal the plain forms' on the same card
    tensors, max abs err 0; one launch count a call."""
    window, mlens, moffs, length, is_tok, codes = _planner_inputs(B, n, B * 7 + n, cuda)
    ll, ol = codes[1], codes[3]
    ops.reset_launch_counts()
    got = dp_cuda.prep_lanes(ll, ol, window, mlens, moffs, length)
    _same(got, dp_cuda.prep_lanes_plain(ll, ol, window, mlens, moffs, length), "prep_lanes")
    lens, offs = mlens[:, :, 0], moffs[:, :, 0]  # strided views
    got = block_torch.token_hist(window, lens, offs, length, is_tok)
    _same(got[:2], block_torch.token_hist_plain(window, lens, offs, is_tok), "token_hist")
    best_len = torch.minimum(lens, torch.clamp(length[:, None] - torch.arange(
        n, device=cuda, dtype=torch.int32)[None, :], min=0))
    best_len = torch.where(best_len >= 3, best_len, 0)
    best_off = torch.where(best_len >= 3, offs, 0)
    marks = chain_cuda.chain_marks(torch.where(best_len >= 3, best_len, 1),
                                   torch.zeros_like(length), length)
    args = (window, best_len, best_off, *codes, marks)
    _same(block_torch.emit_tokens(*args), block_torch.emit_tokens_plain(*args), "emit_tokens")
    h_win, h_lens, h_offs, h_len = plan_cuda.hammer_lanes(n, cuda)
    h_marks = chain_cuda.chain_marks(torch.where(h_lens[:, :, 0] >= 3, h_lens[:, :, 0], 1),
                                     torch.zeros_like(h_len), h_len)
    for label, hl, ho in (("contiguous", h_lens[:, :, 0].contiguous(),
                           h_offs[:, :, 0].contiguous()),
                          ("stride 8", h_lens[:, :, 0], h_offs[:, :, 0])):
        got = block_torch.token_hist(h_win, hl, ho, h_len, h_marks)
        want = block_torch.token_hist_plain(h_win, hl, ho, h_marks)
        _same(got[:2], want, f"token_hist, hammer lanes, {label}")
        assert int(want[0][1, 0x61]) == n and int(want[1][0, 0]) >= n // 258
    counts = ops.launch_counts()
    assert [counts[k] for k in ("prep_lanes", "token_hist", "emit_tokens")] == [1, 3, 1]


def _emit_edge_args(B, n, dev, seed):
    """Emission arguments of B lanes of n positions: the planner inputs'
    lanes (the first full, the last of length 0 where B > 1) with the
    chain's marks of their chosen parse, lane 1 (where B > 2) a lane of
    no match, and random codes below 2^length."""
    window, mlens, moffs, length, _, codes = _planner_inputs(B, n, seed, dev)
    lens, offs = mlens[:, :, 0], moffs[:, :, 0]
    best_len = torch.minimum(lens, torch.clamp(length[:, None] - torch.arange(
        n, device=dev, dtype=torch.int32)[None, :], min=0))
    best_len = torch.where(best_len >= 3, best_len, 0)
    if B > 2:
        best_len[1] = 0  # literals alone
    best_off = torch.where(best_len >= 3, offs, 0)
    marks = chain_cuda.chain_marks(torch.where(best_len >= 3, best_len, 1),
                                   torch.zeros_like(length), length)
    return (window, best_len.contiguous(), best_off.contiguous(), *codes, marks)


@pytest.mark.parametrize("B,n", [(1, 2048), (1, 131072), (3, 4099), (4, 65536), (128, 32768),
                                 (2, 1)])
def test_emit_tokens_edge_shapes_equal_plain(cuda, B, n):
    """The emission kernel at the edges of its tiling: one tile, a lane of
    length 0 (the EOD alone), a lane of no match, n not a multiple of the
    tile nor of a thread's 8 positions (the byte-wise loads), a misaligned
    copy of every row, B = 1 and B = 128: equal to the plain form, one
    launch count a call; a trace shows one emission kernel a call."""
    args = _emit_edge_args(B, n, cuda, B * 31 + n)
    want = block_torch.emit_tokens_plain(*args)
    shifted = [_misaligned(a) for a in args]
    for label, call in (("aligned", args), ("misaligned", shifted)):
        ops.reset_launch_counts()
        got = block_torch.emit_tokens(*call)
        _same(got, want, f"emit_tokens {label} {B} x {n}")
        assert ops.launch_counts()["emit_tokens"] == 1
    if B > 1:
        assert int(want[1][-1]) == int(args[4][-1, 256])  # length 0: the EOD alone
    names = _device_kernels(lambda: block_torch.emit_tokens(*args), "emit_tokens_kernel")
    kernels = {k: v for k, v in names.items() if "emit_tokens" in k}
    assert len(kernels) == 1 and sum(kernels.values()) <= TRACED_CALLS, names
    others = [k for k in names if "emit_tokens" not in k and "memset" not in k.lower()
              and "fill" not in k.lower()]
    assert not others, names


def test_token_hist_unaligned_rows_equal_plain(cuda):
    """Rows the wide loads cannot take (n % 8 != 0, a window and marks
    that start one byte past an 8-byte boundary), with contiguous and
    strided lengths: max abs err 0, one launch a call."""
    window, mlens, moffs, length, is_tok, _ = _planner_inputs(4, 65536, 11, cuda)
    ops.reset_launch_counts()
    calls = 0
    n = 4099  # not a multiple of 8: the byte-wise loads
    for start in (0, 1):  # contiguous rows from an aligned and an unaligned address
        w = torch.empty(4 * n + 1, dtype=torch.uint8, device=cuda)[start : start + 4 * n]
        w = w.view(4, n).copy_(window[:, :n])
        tok = torch.empty(4 * n + 1, dtype=torch.bool, device=cuda)[start : start + 4 * n]
        tok = tok.view(4, n).copy_(is_tok[:, :n])
        for ln, of in ((mlens[:, :n, 0], moffs[:, :n, 0]),
                       (mlens[:, :n, 0].contiguous(), moffs[:, :n, 0].contiguous())):
            got = block_torch.token_hist(w, ln, of, length, tok)[:2]
            _same(got, block_torch.token_hist_plain(w, ln, of, tok), f"token_hist n {n}")
            calls += 1
    assert ops.launch_counts()["token_hist"] == calls


def _lex_keys(rng, B, S):
    """Histogram keys with INF32 for unused symbols and many ties; row 0
    all unused; then, where B allows, the packed word's edges: a row of
    one repeated key, rows of INT32_MIN, of INT32_MAX, of both
    alternating, of small negative keys, and of any int32."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    h = rng.integers(1, 6, (B, S)) * (2 ** rng.integers(0, 9, (B, S)))
    key = np.where(rng.random((B, S)) < 0.3, entropy_torch.INF32, h)
    key[0] = entropy_torch.INF32  # an all-zero histogram
    edges = [np.full(S, 5), np.full(S, lo), np.full(S, hi), np.where(np.arange(S) % 2, lo, hi),
             rng.integers(-3, 3, S), rng.integers(lo, hi, S, endpoint=True)]
    for i, row in enumerate(edges[: B - 1], 1):
        key[i] = row
    return torch.from_numpy(key.astype(np.int32))


@pytest.mark.parametrize("S", [19, 32, 288, 320, 33, 1000, 1024])
@pytest.mark.parametrize("B", [1, 84, 4096])
def test_lex_order_kernel_equals_plain(cuda, S, B):
    """The order of (key, index) at the planner's and splitter's rows
    (4096 lanes: the splitter's batch, at 288 and 320 keys in the
    throughput layout; everything else in the latency layout), keys with INF32 for unused symbols and many ties
    and the packed word's edges, against torch.sort(stable=True) on the
    card."""
    key = _lex_keys(np.random.default_rng(S * 13 + B), B, S).to(cuda)
    ops.reset_launch_counts()
    got = entropy_torch._lex_order(key)
    _same([got], [entropy_torch._lex_order_plain(key)], "lex_order")
    assert ops.launch_counts()["lex_order"] == 1


def test_lex_order_every_layout_equals_plain(cuda):
    """Every layout the C entry picks: each width's latency layout (one
    and 300 rows) and, at P = 512, the throughput layout (from
    LEX_THROUGHPUT_ROWS rows, and a partial last block), on rows of P and
    of P / 2 + 1 keys (the most padding): max abs err 0, one launch a
    call."""
    rng = np.random.default_rng(7)
    ops.reset_launch_counts()
    calls, seen = 0, set()
    for P in (64, 128, 256, 512, 1024):
        for S in (P, P // 2 + 1):
            for B in (1, 300) + ((plan_cuda.LEX_THROUGHPUT_ROWS + 3,) if P == 512 else ()):
                if S <= 32:
                    continue
                key = _lex_keys(rng, B, S).to(cuda)
                got = plan_cuda.launch_lex_order(key)
                layout = plan_cuda.lex_order_layout(B, S)
                _same([got], [entropy_torch._lex_order_plain(key)], f"lex_order {layout}")
                seen.add(layout)
                calls += 1
    assert ops.launch_counts()["lex_order"] == calls
    assert (512, 16, 8) in seen and len(seen) == 6


def test_planner_replay_launches_the_fused_kernels(cuda):
    """A planner bucket (4 lanes of 4096, the last of length 0) run three
    times through its program: eager, captured, replayed. The graph records
    K11-K14 (4 DP preparations, 5 histogram passes, 1 emission, the sorts
    of every MK, Kraft and codeword build), each replay adds them to the
    counts, and every run's plan equals the plain forms' on the CPU."""
    window, mlens, moffs, length, is_tok, _ = _planner_inputs(4, 4096, 5, cuda)
    bucket = (window, mlens, moffs, length, is_tok)
    want = block_torch.plan_block_core(*[t.cpu() for t in bucket])
    ops.reset_launch_counts()
    outs = [programs.run(block_torch.plan_block_core, *bucket) for _ in range(3)]
    torch.cuda.synchronize()
    key = programs.program_key(block_torch.plan_block_core, bucket, {})
    prog = next(p for p in programs.captured(cuda) if p["key"] == key)
    launches = prog["launches"]
    assert launches["prep_lanes"] == 4 and launches["token_hist"] == 5
    assert launches["emit_tokens"] == 1 and launches["lex_order"] > 0, launches
    assert launches["rle_sweep"] == 1, launches
    counts = ops.launch_counts()
    assert all(counts[k] == 3 * launches[k] for k in launches), (counts, launches)
    for out in outs:
        for name in want:
            assert torch.equal(out[name].cpu(), want[name]), name


# ---------------------------------------------------------------------------
# The staircase match finder, compress_sharded and the DP's entry points
# ---------------------------------------------------------------------------


def test_staircase_on_the_card_equals_cpu_and_walk(cuda):
    """Segments of a corpus with a zero run at 64 KiB cores: the staircase
    on the card (eager, captured, replayed) equals its CPU run, rows and
    overflow flags; where a segment does not overflow its rows equal the
    walk kernel's; the overflowing ones are walked on the card."""
    from zultra_tpu_torch.ops import staircase_torch

    corpus = np.concatenate([_corpus(150_000), np.zeros(70_000, np.uint8)])
    core = staircase_torch.STAIRCASE_CORE
    segbufs, _ = build_segments(corpus, [(0, len(corpus))], core)
    bufs = torch.from_numpy(segbufs)
    want = staircase_torch.staircase_segments(bufs, 16, HALO, core)
    assert want[2].any() and not want[2].all()
    for call in range(3):
        got = staircase_torch.staircase_segments(bufs.to(cuda), 16, HALO, core)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), call
    walked = walk_cuda.walk_segments(salcp_batch(bufs.to(cuda)), HALO, core).cpu()
    ok = ~want[2]
    assert torch.equal(want[0][ok], walked[ok] >> 16)
    assert torch.equal(want[1][ok], walked[ok] & 0xFFFF)
    rows = staircase_torch.sharded_rows(segbufs, [cuda], 16, core)
    assert torch.equal(rows.cpu(), walked)
    rows = programs.replay_against_eager(cuda, fn=staircase_torch.staircase_program)
    assert rows and all(r["max_abs_err"] == 0 and r["launches"] == {"suffix_round": 17}
                        for r in rows), rows


def test_match_tables_for_spans_on_the_card(cuda):
    """Three windows and a zero run: the walk path on the card, the
    staircase over ["cuda:0", "cuda:0"] and the staircase on the CPU give
    the same tables."""
    from zultra_tpu_torch.ops import staircase_torch

    corpus = np.concatenate([_corpus(100_000), np.zeros(40_000, np.uint8)])
    spans = [(0, 50_000), (50_000, 100_000), (100_000, len(corpus))]
    want = staircase_torch.match_tables_for_spans(corpus, spans, 32768, devices=["cpu"])
    for got in (staircase_torch.match_tables_for_spans(corpus, spans, 32768, device=cuda),
                staircase_torch.match_tables_for_spans(corpus, spans, 32768,
                                                       devices=["cuda:0", "cuda:0"])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_compress_sharded_on_the_card_equals_golden(cuda):
    """The gzip and dictionary cases through ``compress_sharded`` on
    ["cuda:0", "cuda:0"]: the golden digest, and zlib decodes them."""
    from zultra_tpu_torch.parallel import compress_sharded

    for name in ("gzip", "dictionary"):
        case = _golden_cases()[name]
        data, dictionary = case_inputs(case)
        ops.reset_launch_counts()
        out = compress_sharded(data, ["cuda:0", "cuda:0"], case["flags"], case["block_size"],
                               dictionary=dictionary)
        _assert_golden(f"sharded {name}", case, out)
        counts = ops.launch_counts()
        assert counts["dp"] and counts["chain"] and counts["mk12"], counts
    dec = zlib.decompressobj(15, zdict=dictionary)
    assert dec.decompress(out) + dec.flush() == data


def test_optimize_matches_on_the_card_equals_cpu(cuda):
    """One 64 KiB block past 32 KiB of history and a batch of three blocks
    (one of them empty): the card's choices equal the CPU run's."""
    from zultra_tpu import native
    from zultra_tpu_torch.ops import parse_torch

    window = _corpus(98_304)
    table = native.build_match_table(window, 32768).astype(np.int32)
    rng = np.random.default_rng(5)
    lit, off = rng.integers(4, 14, 288), rng.integers(2, 12, 32)
    job = (lit, off, window, table, 32768, len(window))
    ops.reset_launch_counts()
    got = parse_torch.optimize_matches(*job, device=cuda)
    assert ops.launch_counts()["dp"] == 1 and ops.launch_counts()["prep_lanes"] == 1
    np.testing.assert_array_equal(got, parse_torch.optimize_matches(*job, device="cpu"))
    jobs = [job, (lit, off, window, table, 40000, 50000), (lit, off, window, table, 7, 7)]
    for g, w in zip(parse_torch.optimize_matches_batch(jobs, device=cuda),
                    parse_torch.optimize_matches_batch(jobs, device="cpu")):
        np.testing.assert_array_equal(g, w)


def test_optimize_matches_lane_above_seq_limit_on_the_card(cuda):
    """A block of 1,123,479 positions, past 2^20: the kernel runs its
    segments, equal to the CPU run."""
    from zultra_tpu import native
    from zultra_tpu_torch.ops import parse_torch

    size = 1_118_479 + 5000 + 100
    window = np.frombuffer(mixed_corpus(size, seed=9), np.uint8)
    table = native.build_match_table(window, 100).astype(np.int32)
    rng = np.random.default_rng(9)
    job = (rng.integers(4, 14, 288), rng.integers(2, 12, 32), window, table, 100, size)
    np.testing.assert_array_equal(parse_torch.optimize_matches(*job, device=cuda),
                                  parse_torch.optimize_matches(*job, device="cpu"))
