"""The DP kernel's segment-parallel schedule, as its plain model
(``dp_cuda.dp_segments_model``: speculate, check, fix up, with the
segment size and the warm-up as arguments), against the sequential
recurrence (``dp_choices_plain``) and, once, the JAX package's Pallas DP
in interpret mode. Inputs are the planner's: match tables from the
port's match finder and code lengths from the greedy token histogram,
on numpy-seeded data. Every array is integer: tolerance
is exact equality. Each case also asserts how many segments the fix-up
re-ran, so that no case passes by re-running everything."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu.ops.dp_pallas import run_dp_pallas
from zultra_tpu_torch.corpus import mixed_corpus, random_bytes
from zultra_tpu_torch.ops import block_torch, dp_cuda
from zultra_tpu_torch.ops.dp_cuda import (
    ST_ANCHORED,
    ST_EXACT,
    ST_NONE,
    ST_RERUN,
    ST_SPECULATED,
)
from zultra_tpu_torch.ops.entropy_torch import build_lengths
from zultra_tpu_torch.ops.matchfinder_torch import HALO, match_tables_device_stacked

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

N = 8192


def _tables(data: bytes, n: int, n_lanes: int):
    """Window, match lengths and offsets of ``n_lanes`` consecutive lanes
    of ``n`` bytes each."""
    corpus = np.frombuffer(data, np.uint8)[: n * n_lanes]
    mbs = len(corpus)
    lens, offs = match_tables_device_stacked(corpus, [(0, mbs)], mbs, "cpu")
    win = torch.from_numpy(corpus.copy()).view(n_lanes, n)
    ml = lens[0, HALO : HALO + mbs].reshape(n_lanes, n, 8).contiguous()
    mo = offs[0, HALO : HALO + mbs].reshape(n_lanes, n, 8).contiguous()
    return win, ml, mo


def _dp_inputs(data: bytes, lengths, n=N):
    win, ml, mo = _tables(data, n, len(lengths))
    length = torch.tensor(lengths, dtype=torch.int32)
    g_lit, g_off, _ = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    args = dp_cuda.prep_lanes(build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo,
                              length)
    return (*args, length)


def _run(args, **schedule):
    """The model's choices (checked equal to the sequential recurrence)
    and its status counts."""
    got, st = dp_cuda.dp_choices(*args, status=True, **schedule)
    want = dp_cuda.dp_choices_plain(*args[:4])
    assert torch.equal(got, want)
    vals = st.flatten().tolist()
    return st, {k: vals.count(k) for k in range(6)}


def _zero_run_lane():
    """A lane of mixed data with a 4 KiB zero run in its middle."""
    d = bytearray(mixed_corpus(2 * N, seed=5)[: 2 * N])
    d[2048 : 2048 + 4096] = bytes(4096)
    return bytes(d)


@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_model_anchors_every_segment(kind):
    """At the default segment and warm-up sizes, every speculated
    segment of mixed data and of random bytes anchors: no fix-up."""
    data = mixed_corpus(1 << 16, seed=0)[20000:] if kind == "mixed" else random_bytes(2 * N, 1)
    st, c = _run(_dp_inputs(data, [N, N]))
    assert c[ST_RERUN] == 0 and c[ST_SPECULATED] == 0
    assert c[ST_ANCHORED] == 14 and c[ST_EXACT] == 2  # 8 segments a lane, the top one exact


def test_model_zero_run_fixes_up_part_of_the_lane():
    """Inside a zero run no speculation anchors (its parse is
    phase-locked to the run's end): the run's segments are re-run, the
    mixed data below it anchors again."""
    st, c = _run(_dp_inputs(_zero_run_lane(), [N]), seg=512, warm=512)
    assert 0 < c[ST_RERUN] < 16 - 1
    row = st[0].tolist()
    assert row[-1] == ST_EXACT and row[0] == ST_ANCHORED
    assert any(a == b == ST_RERUN for a, b in zip(row, row[1:]))  # chained fix-ups


def test_model_without_warm_up_reruns_all_but_the_top():
    """warm = 0: nothing can anchor, so the fix-up re-runs every segment
    below the top one (the schedule degenerates to the sequential pass)."""
    st, c = _run(_dp_inputs(mixed_corpus(2 * N, seed=3), [N, N - 1100]), seg=1024, warm=0)
    assert c[ST_RERUN] == 7 + 6 and c[ST_EXACT] == 2 and c[ST_ANCHORED] == 0
    assert st[1, -1] == ST_NONE  # the short lane has 7 segments


@pytest.mark.parametrize("seg,n_rerun", [(259, 5), (512, 0)])
def test_model_ragged_lengths(seg, n_rerun):
    """Lengths 1, seg - 1, seg, seg + 1, one past the last full segment,
    0 and the whole width; a segment whose warm-up reaches the length is
    exact; choice 0 past every length. The smallest segment (warm-up 259)
    leaves a few segments unanchored."""
    n = 4096
    lengths = [1, seg - 1, seg, seg + 1, ((n - 1) // seg) * seg + 3, 0, n]
    args = _dp_inputs(mixed_corpus(len(lengths) * n, seed=9), lengths, n)
    st, c = _run(args, seg=seg, warm=seg)
    got = dp_cuda.dp_choices(*args, status=True, seg=seg, warm=seg)[0]
    for b, ln in enumerate(lengths):
        assert not bool(got[b, ln:].any())
        k = -(-ln // seg)
        assert st[b, k:].eq(ST_NONE).all()
        if k:
            assert st[b, k - 1] == ST_EXACT  # the top segment starts at the length
    assert c[ST_RERUN] == n_rerun and c[ST_ANCHORED] > 4 * n_rerun


@pytest.mark.parametrize("status", [False, True])
def test_lanes_past_max_lane_are_refused(status):
    """Lanes wider than MAX_LANE (2^21, a 2 MiB block) are refused, by the
    plain forms as by the kernel: past it the packed sums of the
    recurrence, (15 bits a position + 20) * 64 + 63, could pass 2^31."""
    assert (15 * dp_cuda.MAX_LANE + 20) * 64 + 63 < 2**31
    n = dp_cuda.MAX_LANE + 1
    lit = torch.zeros((1, n), dtype=torch.int32)
    p = torch.zeros((1, n, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="past 2097152"):
        dp_cuda.dp_choices(lit, p, p, torch.zeros((1, 40), dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32), status=status)


def test_model_equals_pallas_dp():
    """Lengths, best lengths and offsets from the model's choices equal
    the Pallas DP's (interpret mode) on the same lanes, a zero run in one."""
    n = 4096  # the Pallas DP's tile
    data = mixed_corpus(3 * n, seed=12)
    data = data[:n] + bytes(2000) + data[n + 2000 :]
    win, ml, mo = _tables(data, n, 3)
    rng = np.random.default_rng(12)
    ll = torch.from_numpy(rng.integers(4, 16, (3, 288)).astype(np.int32))
    ol = torch.from_numpy(rng.integers(2, 16, (3, 32)).astype(np.int32))
    length = torch.tensor([n, n - 5, 3001], dtype=torch.int32)
    args = dp_cuda.prep_lanes(ll, ol, win, ml, mo, length)
    v, st = dp_cuda.dp_choices(*args, length, status=True, seg=512, warm=512)
    best_len = (v & 511).numpy()
    mcode = (v >> 9).to(torch.int64)
    got = torch.gather(mo, 2, torch.clamp(mcode - 1, min=0)[:, :, None])[:, :, 0]
    best_off = torch.where(mcode > 0, got, 0).numpy()
    jargs = [jnp.asarray(a.numpy()) for a in (ll, ol, win, ml, mo, length)]
    want_len, want_off = run_dp_pallas(*jargs, n, interpret=True)
    np.testing.assert_array_equal(np.asarray(want_len), best_len)
    np.testing.assert_array_equal(np.asarray(want_off), best_off)
    n_rerun = int(st.eq(ST_RERUN).sum())
    assert 0 < n_rerun < int(st.ne(ST_NONE).sum()) // 2
