"""The match stage as one program (zultra_tpu_torch.ops.matchfinder_torch.
match_program) on the CPU, against the JAX package:

- ``segments_from_corpus`` on ``upload_batch``'s one copy against the
  numpy ``build_segments`` and ``zultra_tpu.ops.matchfinder_jax.
  build_segments``, for dictionary bases 0 and 3000, a partial last
  window (a padded, all-sentinel segment), W = 1 and 3;
- the fixed-count doubling against the early-exit form and against
  ``suffix_jax._doubling_rounds`` on the segments of a 96 KiB zero run
  (one of them zeros alone), which need more than the 8 stored rounds;
- ``match_program``'s (lens, offs) and window bytes against
  ``matchfinder_jax.match_tables_device_stacked`` and the window stack of
  ``zultra_tpu.device_pipeline._begin_windows_batched``, for two 32 KiB
  windows after a 3000-byte dictionary (as in tests/test_torch_match.py)
  and for two 64 KiB windows, the last one short (a padded segment);
- through the stand-in graphs of tests/test_torch_programs.py, a shorter
  last window and a dictionary reuse the program of full windows;
- every function the program runs on the card is in the no-host-sync AST
  guard of tests/test_torch_programs.py.

Tolerance: exact equality throughout (all integer)."""

import ast
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zultra_tpu.device_pipeline as jax_pipeline
from zultra_tpu.ops import matchfinder_jax, split_jax, suffix_jax
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import matchfinder_torch as mt
from zultra_tpu_torch.ops import programs, suffix_cuda, suffix_torch, walk_cuda

from test_torch_programs import CAPTURED, StandInGraphs, _host_syncs

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _corpus(base: int, mbs: int, n_windows: int, last: int) -> np.ndarray:
    """A dictionary of ``base`` bytes, then ``n_windows - 1`` windows of
    ``mbs`` and one of ``last`` bytes: mixed text, a zero run, lz data."""
    size = base + (n_windows - 1) * mbs + last
    raw = (mixed_corpus(base + 36000, seed=21) + np.zeros(2000, np.uint8).tobytes()
           + lz_data(max(size, 1), seed=22, alpha=9).tobytes())
    return np.frombuffer(raw, np.uint8)[:size]


def _spans(base: int, mbs: int, n_windows: int, last: int) -> list:
    spans = [(base + i * mbs, base + (i + 1) * mbs) for i in range(n_windows - 1)]
    lo = base + (n_windows - 1) * mbs
    return spans + [(lo, lo + last)]


@pytest.mark.parametrize("base", [0, 3000])
@pytest.mark.parametrize("n_windows, mbs, last", [(1, 65536, 20000), (3, 65536, 20000),
                                                  (3, 32768, 32768)])
def test_segments_from_corpus_equal_build_segments(base, n_windows, mbs, last):
    corpus = _corpus(base, mbs, n_windows, last)
    spans = _spans(base, mbs, n_windows, last)
    corpus_dev, meta, W, k = mt.upload_batch(corpus, spans, mbs, "cpu")
    assert (W, k) == (n_windows, mbs // mt.SEG_CORE)
    assert corpus_dev.shape == (mt.HALO + W * k * mt.SEG_CORE + mt.TAIL,)
    assert meta.shape == (W * k + W, 3) and meta.dtype == torch.int32
    got = mt.segments_from_corpus(corpus_dev, meta[: W * k], mt.SEG_LEN).numpy()
    want, metas = mt.build_segments(corpus, spans, mt.SEG_CORE)
    want_jax, metas_jax = matchfinder_jax.build_segments(corpus, spans, mt.SEG_CORE)
    assert metas == metas_jax
    np.testing.assert_array_equal(want, want_jax)
    S = len(want)
    np.testing.assert_array_equal(got[:S], want)
    # The segments of the last window's missing cores: all sentinels.
    assert S == W * k - (last < mbs and k > 1)
    sentinels = 256 + np.arange(mt.SEG_LEN, dtype=np.int32)
    assert all(np.array_equal(row, sentinels) for row in got[S:])


def test_upload_batch_refuses_spans_it_cannot_lay_out():
    corpus = np.zeros(200000, np.uint8)
    for spans, mbs in (([(0, 32768), (32768, 40000)], 40000),  # a short window not last
                       ([(0, 32768), (32768, 70000)], 32768),  # the last past mbs
                       ([(0, 32768), (98304, 131072)], 32768),  # a gap between windows
                       ([], 32768)):
        with pytest.raises(ValueError):
            mt.upload_batch(corpus, spans, mbs, "cpu")


@pytest.fixture(scope="module")
def zero_run_segments():
    """The four segments of one window of 8000 bytes of text, a 96 KiB zero
    run and 24000 bytes of text: the third segment, halo, core and tail,
    is zeros alone."""
    corpus = np.concatenate([np.frombuffer(mixed_corpus(8000, seed=3), np.uint8),
                             np.zeros(3 << 15, np.uint8),
                             np.frombuffer(mixed_corpus(24000, seed=4), np.uint8)])
    spans = [(0, len(corpus))]
    corpus_dev, meta, W, k = mt.upload_batch(corpus, spans, len(corpus), "cpu")
    bufs = mt.segments_from_corpus(corpus_dev, meta[: W * k], mt.SEG_LEN)
    assert bufs.shape[0] == 4 and not bool(bufs[2].any())
    return bufs


def test_fixed_doubling_equals_early_exit_and_jax(zero_run_segments):
    bufs = zero_run_segments
    n = bufs.shape[1]
    st, stored = suffix_torch.stored_rounds(bufs, 8)
    assert stored.shape == (9, 4, n)
    assert not bool(st.distinct.all()), "the zero run must need more than 8 rounds"
    sa_fixed, ranks_fixed, run_fixed = suffix_torch.doubling_rounds_fixed(bufs, store_levels=8)
    sa_early, ranks_early, run_early = suffix_torch.doubling_rounds(bufs, store_levels=8)
    assert torch.equal(sa_fixed, sa_early) and torch.equal(ranks_fixed, ranks_early)
    assert torch.equal(run_fixed, run_early) and run_fixed.tolist()[2] == 17
    assert torch.equal(ranks_fixed, stored)
    levels = suffix_jax._num_levels(n)
    assert levels == suffix_torch.num_levels(n) == 17
    jax_rounds = jax.jit(functools.partial(suffix_jax._doubling_rounds, n=n, levels=levels,
                                           store_levels=8))
    for s in range(bufs.shape[0]):
        sa_j, ranks_j = jax_rounds(jnp.asarray(bufs[s].numpy()))
        np.testing.assert_array_equal(np.asarray(sa_j), sa_fixed[s].numpy())
        np.testing.assert_array_equal(np.asarray(ranks_j), ranks_fixed[:, s].numpy())


class _Stop(Exception):
    pass


def _jax_window_stack(corpus, spans, mbs, tables, monkeypatch) -> np.ndarray:
    """The window stack that zultra_tpu.device_pipeline._begin_windows_batched
    builds on the host (its match tables given, the run stopped at the
    splitter, which takes the stack padded)."""
    def split(win_p, *args, **kwargs):
        raise _Stop(np.asarray(win_p))

    monkeypatch.setattr(matchfinder_jax, "match_tables_device_stacked",
                        lambda *a, **kw: tables)
    monkeypatch.setattr(split_jax, "_split_kernel_batch", split)
    with pytest.raises(_Stop) as stop:
        jax_pipeline._begin_windows_batched(corpus, spans, mbs)
    return stop.value.args[0][:, : mt.HALO + mbs]


@pytest.mark.parametrize("base, mbs, last", [(3000, 32768, 31768), (0, 50000, 20000)])
def test_match_program_equals_jax(base, mbs, last, monkeypatch):
    """The program's lanes are HALO + k*SEG_CORE wide; ``match_stacks``
    cuts them to HALO + mbs, and nothing lies past that cut."""
    corpus = _corpus(base, mbs, 2, last)
    spans = _spans(base, mbs, 2, last)
    lens_j, offs_j = matchfinder_jax.match_tables_device_stacked(corpus, spans, mbs)
    corpus_dev, meta, W, k = mt.upload_batch(corpus, spans, mbs, "cpu")
    *out, run = mt.match_program(corpus_dev, meta, W=W, k=k)
    lens, offs, win = out
    assert run.shape == (W * k,) and run.dtype == torch.int32
    assert lens.shape == offs.shape == (2, mt.HALO + k * mt.SEG_CORE, 8)
    assert win.shape == (2, mt.HALO + k * mt.SEG_CORE) and win.dtype == torch.uint8
    n_lane = mt.HALO + mbs
    assert not any(bool(x[:, n_lane:].any()) for x in out)
    np.testing.assert_array_equal(np.asarray(lens_j), lens[:, :n_lane].numpy())
    np.testing.assert_array_equal(np.asarray(offs_j), offs[:, :n_lane].numpy())
    assert int((lens > 0).sum()) > 10000
    win_j = _jax_window_stack(corpus, spans, mbs, (lens_j, offs_j), monkeypatch)
    np.testing.assert_array_equal(win_j, win[:, :n_lane].numpy())
    for g, w in zip(mt.match_stacks(corpus, spans, mbs, "cpu"), out):
        assert torch.equal(g, w[:, :n_lane])


def test_shorter_last_window_or_dictionary_adds_no_program_key(monkeypatch):
    """Full windows, a shorter last window, and a 3000-byte dictionary
    before them: one key (first call eager, second captured, third
    replayed through the stand-in graphs), each result equal to the direct
    call's."""
    progs = programs.DevicePrograms(StandInGraphs())
    monkeypatch.setattr(programs, "run",
                        lambda fn, *inputs, **statics: progs.run(fn, inputs, statics))
    mbs = 32768
    cases = [(0, mbs), (0, 5000), (3000, 12000)]
    got = []
    for base, last in cases:
        corpus = _corpus(base, mbs, 2, last)
        got.append((corpus, _spans(base, mbs, 2, last),
                    mt.match_stacks(corpus, _spans(base, mbs, 2, last), mbs, "cpu")))
    assert len(progs.programs) == 1 and not progs.seen
    [key] = progs.programs
    assert key[0] is mt.match_program and dict(key[2]) == {"W": 2, "k": 1}
    assert (progs.graphs.captures, progs.graphs.replays) == (1, 2)
    monkeypatch.undo()
    for corpus, spans, out in got:
        for g, w in zip(out, mt.match_stacks(corpus, spans, mbs, "cpu")):
            assert torch.equal(g, w)


# The forms the program calls only on a CPU tensor, and host arithmetic on
# shapes (Python ints, no tensor).
CPU_ONLY = {"doubling_rounds", "walk_segments_plain"}
SHAPE_ARITHMETIC = {"num_levels", "n_chunks", "fits"}


def _reached(fn, modules, seen) -> None:
    """Every function of ``modules`` that ``fn`` names (calls, or picks to
    call), and so on down, but not into a CPU-only form."""
    for node in ast.walk(ast.parse(inspect.getsource(fn).lstrip())):
        if isinstance(node, ast.Name):
            callee = fn.__globals__.get(node.id)
            if (inspect.isfunction(callee) and callee.__module__ in modules
                    and callee.__name__ not in seen):
                seen.add(callee.__name__)
                if callee.__name__ not in CPU_ONLY:
                    _reached(callee, modules, seen)


def test_match_program_functions_join_the_host_sync_guard():
    modules = {m.__name__: m for m in (mt, suffix_torch, suffix_cuda, walk_cuda)}
    reached = {"match_program"}
    _reached(mt.match_program, modules, reached)
    guarded = {name for m in modules.values() for name in CAPTURED[m]}
    assert reached - CPU_ONLY - SHAPE_ARITHMETIC == guarded
    assert CPU_ONLY <= reached
    assert not {name: _host_syncs(getattr(m, name)) for m in modules.values()
                for name in CAPTURED[m] if _host_syncs(getattr(m, name))}
    # The early-exit form is what the guard would refuse under a capture.
    assert _host_syncs(suffix_torch.doubling_rounds) == ["bool(...)"]
