"""The staircase match finder of the port (ops/staircase_torch.py) on the
CPU: ``staircase_segments`` against the JAX ``_staircase_kernel`` (rows
and overflow flags), against the port's plain walk on the same segments,
and ``match_tables_for_spans`` against the JAX form under a 1-axis and a
2-axis mesh. Lengths and offsets are integers: exact equality."""

import inspect
import sys

import numpy as np
import pytest
import torch

from zultra_tpu.ops.matchfinder_jax import _staircase_kernel
from zultra_tpu.ops.matchfinder_jax import match_tables_for_spans as match_tables_jax
from zultra_tpu.parallel import make_mesh
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import nsv_torch, programs, staircase_torch, suffix_torch, walk_cuda
from zultra_tpu_torch.ops import matchfinder_torch as mt

from test_torch_match_program import _reached
from test_torch_programs import CAPTURED, StandInGraphs, _host_syncs

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

N = 4096


def _buffer(data: bytes, n: int = N) -> np.ndarray:
    """n int32 symbols: the bytes, then unique sentinels."""
    buf = 256 + np.arange(n, dtype=np.int32)
    raw = np.frombuffer(data, np.uint8)[:n]
    buf[: raw.shape[0]] = raw
    return buf


CASES = {
    "mixed": lambda: _buffer(mixed_corpus(4000, seed=1)),
    "lz_data": lambda: _buffer(lz_data(N, seed=2).tobytes()),
    "random": lambda: _buffer(np.random.default_rng(3).integers(0, 256, N, np.uint8).tobytes()),
    "zero run": lambda: _buffer(bytes(3000) + mixed_corpus(1096, seed=4)),
    "period 2": lambda: _buffer(b"ab" * 1500),
}


@pytest.mark.parametrize("budget", [16, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_staircase_segments_equal_jax_kernel(case, budget):
    """Each case beside an all-sentinel segment (a batch of two): rows and
    the overflow flag equal the JAX kernel's; budget 4 makes more of them
    overflow, and an overflowing segment reports no rows."""
    bufs = np.stack([CASES[case](), 256 + np.arange(N, dtype=np.int32)])
    lens, offs, over = staircase_torch.staircase_segments(torch.from_numpy(bufs), budget, 0, N)
    assert lens.shape == offs.shape == (2, N, 8) and lens.dtype == torch.int32
    for s in range(2):
        j_lens, j_offs, j_over = _staircase_kernel(bufs[s], N, budget)
        np.testing.assert_array_equal(lens[s].numpy(), np.asarray(j_lens))
        np.testing.assert_array_equal(offs[s].numpy(), np.asarray(j_offs))
        assert bool(over[s]) == bool(j_over)
        if bool(over[s]):
            assert not lens[s].any()
    assert not bool(over[1]) and not lens[1].any()


def test_budget_overflow_flags():
    """A long zero run overflows the default budget; text does not; a
    budget of 1 overflows text too."""
    bufs = torch.from_numpy(np.stack([CASES["zero run"](), CASES["mixed"]()]))
    assert staircase_torch.staircase_segments(bufs, 16, 0, N)[2].tolist() == [True, False]
    assert staircase_torch.staircase_segments(bufs, 1, 0, N)[2].tolist() == [True, True]


def test_staircase_core_slice():
    bufs = torch.from_numpy(np.stack([CASES["mixed"](), CASES["lz_data"]()]))
    full = staircase_torch.staircase_segments(bufs, 16, 0, N)
    part = staircase_torch.staircase_segments(bufs, 16, 1000, 2048)
    for f, p in zip(full[:2], part[:2]):
        assert torch.equal(p, f[:, 1000:3048])


def _segments(seg_core: int):
    data = np.frombuffer(mixed_corpus(40000, seed=8) + lz_data(9000, seed=9).tobytes(), np.uint8)
    return mt.build_segments(data, [(0, 30000), (30000, len(data))], seg_core)[0]


def test_staircase_equals_plain_walk():
    """The staircase's rows equal the port's walk (plain form) on the same
    [HALO | core | TAIL] segments, none of which overflows."""
    core = 8192
    segbufs = _segments(core)
    assert segbufs.shape[0] == 7
    bufs = torch.from_numpy(segbufs)
    lens, offs, over = staircase_torch.staircase_segments(bufs, 16, mt.HALO, core)
    assert not over.any()
    rows = walk_cuda.walk_segments_plain(mt.salcp_batch(bufs), mt.HALO, core)
    assert torch.equal(lens, rows >> 16) and torch.equal(offs, rows & 0xFFFF)
    assert lens.any()


def _spans_corpus(base: int):
    data = np.frombuffer(mixed_corpus(base + 50000, seed=7)
                         + bytes(6000) + lz_data(4000, seed=10).tobytes(), np.uint8)
    spans = [(base, base + 24000), (base + 24000, base + 48000), (base + 48000, len(data))]
    return data, spans


@pytest.mark.parametrize("base", [0, 3000])
@pytest.mark.parametrize("n_dp, n_sp", [(2, 1), (2, 2)])
def test_match_tables_for_spans_equal_jax_mesh(n_dp, n_sp, base):
    """Three windows (the last holds a 6000-byte zero run), with and
    without 3000 bytes of history before the first (a dictionary offset),
    16 KiB segment cores: the staircase sharded over n_dp * n_sp CPU
    devices equals the JAX form under the mesh ("dp",) or ("dp", "sp"),
    table for table; the walk path equals it too."""
    data, spans = _spans_corpus(base)
    want = match_tables_jax(data, spans, seg_core=16384, mesh=make_mesh(n_dp=n_dp, n_sp=n_sp))
    got = staircase_torch.match_tables_for_spans(data, spans, seg_core=16384,
                                                 devices=["cpu"] * (n_dp * n_sp))
    walked = staircase_torch.match_tables_for_spans(data, spans, seg_core=16384, device="cpu")
    assert len(got) == len(want) == len(walked) == 3
    for g, w, k in zip(got, want, walked):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(k, w)


def test_overflowing_segments_are_walked_and_counted(monkeypatch):
    """A zero-heavy corpus: the segments over the zero run overflow, are
    walked on the same device and counted; the tables equal the JAX form's
    (its host walk)."""
    monkeypatch.setattr(staircase_torch, "FALLBACK_STATS", {"segments": 0, "overflowed": 0})
    data = np.frombuffer(mixed_corpus(10000, seed=12) + bytes(30000)
                         + mixed_corpus(8000, seed=13), np.uint8)
    spans = [(0, 32768), (32768, len(data))]
    got = staircase_torch.match_tables_for_spans(data, spans, seg_core=16384,
                                                 devices=["cpu", "cpu"])
    stats = staircase_torch.FALLBACK_STATS
    assert stats["segments"] == 3 and stats["overflowed"] >= 1
    want = match_tables_jax(data, spans, seg_core=16384, mesh=make_mesh(n_dp=2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fallback_stats_whole_under_threads(monkeypatch):
    """Sixteen device threads (more than the cores) with a short switch
    interval, the staircase and the walk stood in for: every segment and
    every overflow is counted once, and the rows of exactly the
    overflowing segments come from the walk."""
    monkeypatch.setattr(staircase_torch, "FALLBACK_STATS", {"segments": 0, "overflowed": 0})

    def staircase(bufs, *, budget_factor, core_off, core_len):  # overflow where symbol 0 is 0
        return torch.zeros((bufs.shape[0], core_len, 8), dtype=torch.int32), bufs[:, 0] == 0

    monkeypatch.setattr(programs, "run", lambda fn, *inputs, **statics: staircase(*inputs,
                                                                                 **statics))
    monkeypatch.setattr(staircase_torch, "salcp_batch", lambda bufs: bufs)
    monkeypatch.setattr(staircase_torch, "walk_segments", lambda salcp, halo, core: torch.ones(
        (salcp.shape[0], core, 8), dtype=torch.int32))
    segbufs = np.tile(256 + np.arange(64, dtype=np.int32), (200, 1))
    segbufs[::3, 0] = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            rows = staircase_torch.sharded_rows(segbufs, ["cpu"] * 16, 16, 4)
    finally:
        sys.setswitchinterval(interval)
    assert staircase_torch.FALLBACK_STATS == {"segments": 1000, "overflowed": 5 * 67}
    assert rows.shape == (200, 4, 8)
    assert rows[::3].all() and not rows[1::3].any() and not rows[2::3].any()


def test_sharded_rows_programs_one_key(monkeypatch):
    """Through stand-in graphs: the shares of two devices run programs of
    one shape (first call eager, then captured, then replayed), and the
    rows equal a direct call's."""
    progs = programs.DevicePrograms(StandInGraphs())
    segbufs = _segments(8192)  # 7 segments: shares of 4 and 3, each padded to 8
    direct = staircase_torch.sharded_rows(segbufs, ["cpu"], 16, 8192)
    monkeypatch.setattr(programs, "run",
                        lambda fn, *inputs, **statics: progs.run(fn, inputs, statics))
    got = [staircase_torch.sharded_rows(segbufs, ["cpu", "cpu"], 16, 8192) for _ in range(2)]
    assert len(progs.programs) == 1 and not progs.seen
    [key] = progs.programs
    assert key[0] is staircase_torch.staircase_program and key[1][0][0] == (staircase_torch.PROGRAM_SEGMENTS, segbufs.shape[1])
    assert (progs.graphs.captures, progs.graphs.replays) == (1, 3)
    for rows in got:
        assert torch.equal(rows, direct)


def test_staircase_program_functions_join_the_host_sync_guard():
    """Every function the staircase program reaches in the port's modules
    is in the host-sync guard's list (or a CPU-only form), and none syncs."""
    modules = {m.__name__: m for m in (staircase_torch, nsv_torch, suffix_torch)}
    reached = {"staircase_program"}
    _reached(staircase_torch.staircase_program, modules, reached)
    guarded = {name for m in modules.values() for name in CAPTURED[m]}
    assert reached - {"doubling_rounds", "num_levels"} <= guarded
    assert {"staircase_program", "_staircase_rows", "build_sparse_min", "find_left",
            "find_right", "pair_lcp"} <= reached
    assert not [name for name in reached & guarded
                for m in modules.values() if name in CAPTURED[m]
                and _host_syncs(getattr(m, name))]
    assert "programs.run" in inspect.getsource(staircase_torch.staircase_segments)
