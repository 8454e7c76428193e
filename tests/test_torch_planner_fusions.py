"""The planner's fused per-position passes in the port against the JAX
package on the CPU: the DP's lane preparation (``dp_cuda.prep_lanes``
against ``jax.vmap(dp_pallas._prep_lane)``), the token histograms given
the token marks (``block_torch.token_hist`` against
``block_jax._token_hist``), token emission (``block_torch.emit_tokens``
against ``block_jax._emit_tokens``) and the (key, index) order of short
rows (``entropy_torch._lex_order`` against ``lax.sort((key, iota),
num_keys=2)``). Each plain form, and each plain model of a kernel's
schedule in ``ops/plan_cuda.py`` (K11-K14), is held against JAX on
numpy-seeded lanes with their edges: a lane of length 0, a match that
crosses the lane's length, offsets 1, 256, 257 and 32768, a length of
258, all-zero histograms and the INF32 keys of unused symbols. The token
histograms also take a lane of all zeros and a lane of one literal byte
(one bin hammered), at the kernel's tile and at tiles of the model's
alone; the order takes rows of 1 to 1024 keys, of one repeated key,
negative keys and INT32_MIN / INT32_MAX, under both network layouts. Then the whole planner with the four models in place of the
plain forms against ``block_jax._plan_block_core`` plus ``_emit_part``.
Every output is integer: tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from zultra_tpu.ops import block_jax
from zultra_tpu.ops.dp_pallas import _prep_lane
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import block_torch, dp_cuda, entropy_torch
from zultra_tpu_torch.ops import plan_cuda as pc
from zultra_tpu_torch.ops.chain_cuda import chain_marks_plain
from zultra_tpu_torch.ops.entropy_torch import INF32, build_lengths, canonical_codewords
from zultra_tpu_torch.ops.matchfinder_torch import HALO, match_tables_device_stacked
from zultra_tpu_torch.ops.tables import device_tables

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

N = 8192  # positions a lane
EDGE_OFFSETS = (1, 256, 257, 32768)


def _eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got), err_msg=msg)


def _lanes(seed=5):
    """Four lanes of N positions: window bytes, match tables (B, N, 8)
    and lengths. Lane 0 has length 0; lane 1 ends 100 positions early,
    with a match of 258 crossing its end; lane 2 is a zero run with the
    edge offsets in its table; lane 3 is seeded LZ data."""
    rng = np.random.default_rng(seed)
    B = 4
    win = np.stack([np.frombuffer(mixed_corpus(N, seed=seed), np.uint8)[:N],
                    rng.integers(0, 256, N, dtype=np.uint8),
                    np.zeros(N, np.uint8),
                    lz_data(N, seed=seed + 1, alpha=5, p_match=0.6)[:N]])
    mlens = rng.integers(0, 259, (B, N, 8)).astype(np.int32)
    mlens[rng.random((B, N, 8)) < 0.4] = 0
    mlens[rng.random((B, N, 8)) < 0.2] = rng.integers(3, 40, 1)[0]
    # The first row, which the token marks follow: mostly literals, short
    # matches and a few of 258.
    u = rng.random((B, N))
    mlens[:, :, 0] = np.where(u < 0.1, rng.integers(3, 20, (B, N)), np.where(u > 0.998, 258, 0))
    mlens[1, N - 400 : N - 120, 0] = 0  # literals up to a match of 258 that crosses
    mlens[1, N - 120, 0] = 258  # the end of lane 1: the chain lands on it
    mlens[2, :, 0] = np.minimum(258, N - np.arange(N))
    mlens[2, :, 1:4] = 258
    moffs = rng.integers(1, 32769, (B, N, 8)).astype(np.int32)
    moffs[:, :, 0] = rng.choice(EDGE_OFFSETS + (2, 3, 4, 5, 1000), (B, N))
    moffs[1, N - 120, 0] = 32768
    moffs[2, :, 0] = 1
    moffs[2, :, 1:4] = np.array([256, 257, 32768])
    moffs = np.where(mlens >= 3, moffs, 0).astype(np.int32)
    length = np.array([0, N - 100, N, N - 1], np.int32)
    return win, mlens, moffs, length


def _code_lengths(win, mlens, moffs, length, dynamic):
    """Code lengths the planner would give the lanes (the greedy token
    histograms'), or the static tables; unused symbols priced as the
    planner prices them (9 and 6)."""
    B = win.shape[0]
    if not dynamic:
        t = device_tables("cpu")
        return t.static_lit_len.repeat(B, 1), t.static_off_len.repeat(B, 1)
    lit, off, _ = block_torch.token_hist(torch.from_numpy(win), torch.from_numpy(mlens[:, :, 0]),
                                         torch.from_numpy(moffs[:, :, 0]),
                                         torch.from_numpy(length))
    ll, ol = build_lengths(lit, 15), build_lengths(off, 15)
    return torch.where(ll == 0, 9, ll), torch.where(ol == 0, 6, ol)


@pytest.fixture(scope="module")
def lanes():
    return _lanes()


# ---------------------------------------------------------------------------
# K11: the DP's lane preparation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_prep_lanes_plain_and_model_equal_jax(lanes, dynamic):
    win, mlens, moffs, length = lanes
    ll, ol = _code_lengths(win, mlens, moffs, length, dynamic)
    want = jax.vmap(lambda a, b, c, d, e, f: _prep_lane(a, b, c, d, e, f, N))(
        jnp.asarray(ll.numpy()), jnp.asarray(ol.numpy()), jnp.asarray(win), jnp.asarray(mlens),
        jnp.asarray(moffs), jnp.asarray(length))
    args = [torch.from_numpy(a) for a in (win, mlens, moffs, length)]
    plain = dp_cuda.prep_lanes(ll, ol, *args)
    *model, stats = pc.prep_lanes_model(ll, ol, *args, tile=1000)
    assert stats["tiles"] == 4 * 9
    for name, w, p, m in zip(("lit", "p1", "p2", "varlen40"), want, plain, model):
        _eq(w, p, f"plain {name}")
        _eq(w, m, f"model {name}")
        assert p.dtype == m.dtype == torch.int32 and p.is_contiguous()
    assert int(plain[0][0].abs().sum()) == 0  # length 0: no literal costs
    assert int(plain[0][1, N - 100 :].abs().sum()) == 0


# ---------------------------------------------------------------------------
# K12: token histograms given the token marks
# ---------------------------------------------------------------------------


def _marks(lens, length):
    return chain_marks_plain(torch.where(lens >= 3, lens, 1), torch.zeros_like(length), length)


@pytest.fixture(scope="module")
def hist_lanes(lanes):
    """The four lanes and two that hammer one bin: a lane of all zeros
    (every position a literal 0) and a lane of one literal byte."""
    win, mlens, moffs, length = lanes
    zeros = np.zeros((2, N, 8), np.int32)
    return (np.concatenate([win, np.zeros((1, N), np.uint8), np.full((1, N), 0x61, np.uint8)]),
            np.concatenate([mlens, zeros]), np.concatenate([moffs, zeros]),
            np.concatenate([length, [N, N]]).astype(np.int32))


@pytest.mark.parametrize("tile", [pc.TILE, 1000, 64, 2048, 1024, 512, 256, 128])
def test_token_hist_plain_and_model_equal_jax(hist_lanes, tile):
    """The kernel's tile (HIST_TILE, 1024, at every bucket) and tiles of
    the model's alone: the sums stay exact under any split of the lane
    (1000, 128, 64: partial warps, many blocks a lane)."""
    win, mlens, moffs, length = hist_lanes
    B = win.shape[0]
    lens, offs = torch.from_numpy(mlens[:, :, 0]), torch.from_numpy(moffs[:, :, 0])
    is_tok = _marks(lens, torch.from_numpy(length))
    want_lit, want_off, _ = jax.jit(block_jax._token_hist, static_argnums=4)(
        jnp.asarray(win), jnp.asarray(mlens[:, :, 0]), jnp.asarray(moffs[:, :, 0]),
        jnp.asarray(length), N, jnp.asarray(is_tok.numpy()))
    lit, off, tok = block_torch.token_hist(torch.from_numpy(win), lens, offs,
                                           torch.from_numpy(length), is_tok)
    assert tok is is_tok
    _eq(want_lit, lit, "plain lit")
    _eq(want_off, off, "plain off")
    for seed in (0, 1):
        m_lit, m_off, stats = pc.token_hist_model(torch.from_numpy(win), lens, offs, is_tok,
                                                  tile=tile, order_seed=seed)
        _eq(want_lit, m_lit, "model lit")
        _eq(want_off, m_off, "model off")
        assert stats["blocks"] == B * -(-N // tile) and stats["runs"] == B * N // pc.RUN
    # Lane 0 (length 0) holds the EOD alone, every run of it skipped; lane
    # 1's crossing match counts; the zero run's matches hammer symbols 285
    # and 0, the last two lanes one literal bin; one shared add a token and
    # one a match's offset.
    assert int(lit[0].sum()) == 1 and int(lit[0, 256]) == 1 and int(off[0].sum()) == 0
    assert stats["runs_skipped"] >= N // pc.RUN
    assert bool(is_tok[1, N - 120]) and int(lit[1, 285]) >= 1
    assert int(lit[2, 285]) >= N // 258 - 1 and int(off[2, 0]) == int(lit[2, 257:].sum())
    assert int(lit[4, 0]) == N and int(lit[5, 0x61]) == N
    assert stats["shared_adds"] == int(is_tok.sum()) + int(np.asarray(want_off).sum())


def test_token_hist_strided_and_greedy_marks_equal_jax(hist_lanes):
    """The planner's greedy call: the match tables' first slot (a view of
    stride 8) and greedy marks cut at each lane's length; also the
    chain's own marks (is_tok None)."""
    win, mlens, moffs, length = hist_lanes
    ml, mo = torch.from_numpy(mlens), torch.from_numpy(moffs)
    ln = torch.from_numpy(length)
    greedy = chain_marks_plain(torch.where(ml[:, :, 0] >= 3, ml[:, :, 0], 1),
                               torch.zeros_like(ln), torch.full_like(ln, N))
    greedy = greedy & (torch.arange(N)[None, :] < ln[:, None])
    for marks in (greedy, None):
        got = block_torch.token_hist(torch.from_numpy(win), ml[:, :, 0], mo[:, :, 0], ln, marks)
        want = jax.jit(block_jax._token_hist, static_argnums=4)(
            jnp.asarray(win), jnp.asarray(mlens[:, :, 0]), jnp.asarray(moffs[:, :, 0]),
            jnp.asarray(length), N, None if marks is None else jnp.asarray(marks.numpy()))
        for w, g in zip(want, got):
            _eq(w, g)
        model = pc.token_hist_model(torch.from_numpy(win), ml[:, :, 0], mo[:, :, 0], got[2])
        _eq(want[0], model[0])
        _eq(want[1], model[1])
        assert model[2]["tile"] == pc.HIST_TILE


# ---------------------------------------------------------------------------
# K13: token emission
# ---------------------------------------------------------------------------


def _emit_case(lanes):
    """A chosen parse of the lanes (the first match row where it is a
    match), its token marks, and the planner's codes: lanes 0 and 1
    static, 2 and 3 dynamic from the parse's own histograms."""
    win, mlens, moffs, length = lanes
    ln = torch.from_numpy(length)
    best_len = torch.from_numpy(np.where(mlens[:, :, 0] >= 3, mlens[:, :, 0], 0).astype(np.int32))
    best_off = torch.from_numpy(np.where(mlens[:, :, 0] >= 3, moffs[:, :, 0], 0).astype(np.int32))
    # a chosen match never crosses the lane's end
    best_len = torch.minimum(best_len, torch.clamp(ln[:, None] - torch.arange(N)[None, :], min=0))
    best_len = torch.where(best_len >= 3, best_len, 0)
    best_off = torch.where(best_len >= 3, best_off, 0)
    is_tok = _marks(best_len, ln)
    w = torch.from_numpy(win)
    lit, off, _ = block_torch.token_hist(w, best_len, best_off, ln, is_tok)
    lit_len, off_len = build_lengths(lit, 15), build_lengths(off, 15)
    t = device_tables("cpu")
    dyn = torch.tensor([False, False, True, True])[:, None]
    lit_cw = torch.where(dyn, canonical_codewords(lit_len), t.static_lit_cw[None, :])
    off_cw = torch.where(dyn, canonical_codewords(off_len), t.static_off_cw[None, :])
    lit_len = torch.where(dyn, lit_len, t.static_lit_len[None, :])
    off_len = torch.where(dyn, off_len, t.static_off_len[None, :])
    return w, best_len, best_off, lit_cw, lit_len, off_cw, off_len, is_tok, ln


@pytest.fixture(scope="module")
def emit_case(lanes):
    case = _emit_case(lanes)
    *args, ln = case
    want = jax.jit(block_jax._emit_tokens, static_argnums=8)(
        *[jnp.asarray(a.numpy()) for a in args[:7]], jnp.asarray(ln.numpy()), N,
        jnp.asarray(args[7].numpy()))
    return args, [np.asarray(x) for x in want]


def test_emit_tokens_plain_equals_jax(emit_case):
    args, (want_words, want_bits) = emit_case
    words, total_bits = block_torch.emit_tokens(*args)
    assert words.dtype == torch.int64 and total_bits.dtype == torch.int32
    _eq(want_words.astype(np.int64), words, "words")
    _eq(want_bits, total_bits, "total_bits")
    assert int(total_bits[0]) == int(args[4][0, 256])  # length 0: the EOD alone


@pytest.mark.parametrize("tile,per_thread,seed", [
    (pc.EMIT_TILE, pc.EMIT_PER, 0), (pc.EMIT_TILE, pc.EMIT_PER, 7), (64, 4, 1), (100, 5, 2),
    (32, 1, 3)])
def test_emit_tokens_model_equals_jax(emit_case, tile, per_thread, seed):
    """The one launch's schedule, tiles completing in a seeded order: with
    small tiles many tiles start inside a word, so words take bits from
    two tiles, look-backs wait on tiles not yet published, and fields
    straddle word edges; at every tile size threads share words in shared
    memory."""
    args, (want_words, want_bits) = emit_case
    words, total_bits, stats = pc.emit_tokens_model(*args, tile=tile, per_thread=per_thread,
                                                    order_seed=seed)
    _eq(want_words.astype(np.int64), words, "words")
    _eq(want_bits, total_bits, "total_bits")
    assert stats["tiles"] == 4 * -(-N // tile)
    assert stats["straddle_word"] > 0 and stats["thread_shared_words"] > 0
    assert stats["lookback_rounds"] >= 4 * (-(-N // tile) - 1)  # every tile past a lane's first
    if tile < pc.EMIT_TILE:
        assert stats["unaligned_tiles"] > 0 and stats["shared_words"] > 0
        assert stats["lookback_waits"] > 0


def _emit_edge_case():
    """Three lanes of 1000 positions (not a multiple of any tile below):
    lane 0 of length 0 (the EOD alone), lane 1 with tokens in its first 90
    positions alone (tiles with no token), lane 2 of literals and matches
    to its end; dynamic codes from the lanes' own histograms."""
    rng = np.random.default_rng(21)
    n = 1000
    win = rng.integers(0, 256, (3, n)).astype(np.uint8)
    mlens = np.where(rng.random((3, n, 8)) < 0.2, rng.integers(3, 259, (3, n, 8)), 0)
    moffs = np.where(mlens >= 3, rng.choice(EDGE_OFFSETS + (2, 77), (3, n, 8)), 0)
    length = np.array([0, 90, n], np.int32)
    lanes = (win, mlens.astype(np.int32), moffs.astype(np.int32), length)
    ln = torch.from_numpy(length)
    best_len = torch.from_numpy(mlens[:, :, 0].astype(np.int32))
    best_len = torch.minimum(best_len, torch.clamp(ln[:, None] - torch.arange(n)[None, :], min=0))
    best_len = torch.where(best_len >= 3, best_len, 0)
    best_off = torch.where(best_len >= 3, torch.from_numpy(lanes[2][:, :, 0]), 0)
    is_tok = _marks(best_len, ln)
    w = torch.from_numpy(win)
    lit, off, _ = block_torch.token_hist(w, best_len, best_off, ln, is_tok)
    lit_len, off_len = build_lengths(lit, 15), build_lengths(off, 15)
    args = [w, best_len, best_off, canonical_codewords(lit_len), lit_len,
            canonical_codewords(off_len), off_len, is_tok]
    want = jax.jit(block_jax._emit_tokens, static_argnums=8)(
        *[jnp.asarray(a.numpy()) for a in args[:7]], jnp.asarray(length), n,
        jnp.asarray(is_tok.numpy()))
    return args, [np.asarray(x) for x in want]


@pytest.fixture(scope="module")
def emit_edge_case():
    return _emit_edge_case()


@pytest.mark.parametrize("tile,per_thread,resident,seed",
                         [(pc.EMIT_TILE, pc.EMIT_PER, 8, 0), (64, 8, 1, 4), (64, 8, 64, 5),
                          (48, 2, 3, 6)])
def test_emit_tokens_model_edge_lanes_equal_jax(emit_edge_case, tile, per_thread, resident,
                                               seed):
    """A lane of length 0, tiles with no token, a last tile cut short, one
    block resident at a time (tiles in ticket order) and many in a seeded
    order: the plain form and the model equal ``block_jax._emit_tokens``."""
    args, (want_words, want_bits) = emit_edge_case
    _eq(want_words.astype(np.int64), block_torch.emit_tokens(*args)[0], "plain words")
    words, total_bits, stats = pc.emit_tokens_model(*args, tile=tile, per_thread=per_thread,
                                                    order_seed=seed, resident=resident)
    _eq(want_words.astype(np.int64), words, "words")
    _eq(want_bits, total_bits, "total_bits")
    assert int(total_bits[0]) == int(args[4][0, 256])  # length 0: the EOD alone
    assert stats["tiles"] == 3 * -(-1000 // tile)
    if resident == 1:
        assert stats["lookback_waits"] == 0


@pytest.mark.parametrize("case", ["emit_case", "emit_edge_case"])
def test_emit_fields_fit_their_bits(request, case):
    """The kernel and its model OR each field into the words where the
    plain form and ``block_jax._emit_tokens`` add: the two agree because
    every field's value lies below 2^its width. Holds on the path's codes
    (the static tables, ``canonical_codewords`` of built lengths)."""
    args, _ = request.getfixturevalue(case)
    fields = pc.emit_fields(*[a.numpy() for a in args])
    for v, n in (fields[:2], fields[2:]):
        assert (v >= 0).all() and (n >= 0).all() and (n <= 64).all()
        assert ((v >> n) == 0).all()
    assert (fields[1] > 0).any() and (fields[3] > 0).any()


# ---------------------------------------------------------------------------
# K14: the (key, index) order of short rows
# ---------------------------------------------------------------------------


def _keys(S, seed):
    """Rows as the planner sorts them: histograms with INF32 for unused
    symbols (mk_inputs), length * S + symbol keys (kraft_inputs,
    canonical_codewords); an all-unused row, a one-symbol row, a row of
    equal weights, and seeded rows with many ties; then the edges of the
    packed word: rows of INT32_MIN, of INT32_MAX, of both alternating, and
    of small negative keys with ties."""
    rng = np.random.default_rng(seed)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    rows = [np.full(S, INF32), np.where(np.arange(S) == S // 2, 7, INF32), np.full(S, 5)]
    for _ in range(40):
        h = rng.integers(1, 6, S) * (rng.integers(1, 4) ** rng.integers(0, 9, S))
        rows.append(np.where(rng.random(S) < 0.3, INF32, h))
    lens = rng.integers(0, 16, (20, S))
    rows += list(np.where(lens > 0, lens * S + np.arange(S), INF32))
    rows += [np.full(S, lo), np.full(S, hi), np.where(np.arange(S) % 2, lo, hi),
             rng.choice([lo, hi, -1, 0, 1], S), rng.integers(-3, 3, S),
             rng.integers(lo, hi, S, endpoint=True)]
    return torch.from_numpy(np.stack(rows).astype(np.int32))


@pytest.mark.parametrize("S", [19, 32, 288, 320, 1, 2, 33, 1000, 1024])
def test_lex_order_plain_and_model_equal_jax(S):
    """The warp kernel's rank count up to 32 keys, the network above in
    the latency layout; at P = 512 also a batch of LEX_THROUGHPUT_ROWS
    rows, the first the C entry sorts in the throughput layout."""
    key = _keys(S, S)
    iota = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), key.shape)
    _, want = jax.jit(lambda k: lax.sort((k, iota), dimension=1, num_keys=2))(
        jnp.asarray(key.numpy()))
    _eq(want, entropy_torch._lex_order(key), "plain")
    got, stats = pc.lex_order_model(key)
    _eq(want, got, "model")
    assert got.dtype == torch.int64 and stats["rows"] == key.shape[0]
    assert stats["ties"] > 0 or S == 1
    layout = pc.lex_order_layout(key.shape[0], S)
    if S <= 32:
        assert layout is None and stats["stages"] == 0
        return
    P, E, rows = layout
    log_p = P.bit_length() - 1
    assert (P, rows) == (max(64, 1 << (S - 1).bit_length()), 1) and E == max(2, P // 256)
    assert stats["stages"] == log_p * (log_p + 1) // 2 and stats["padded"] == key.shape[0] * (P - S)
    if P != 512:
        return
    B = pc.LEX_THROUGHPUT_ROWS
    big = torch.cat([_keys(S, S + i) for i in range(-(-B // key.shape[0]))])[:B]
    iota = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), big.shape)
    _, want = jax.jit(lambda k: lax.sort((k, iota), dimension=1, num_keys=2))(
        jnp.asarray(big.numpy()))
    got, st = pc.lex_order_model(big)
    _eq(want, got, "model, throughput layout")
    assert pc.lex_order_layout(B, S) == (512, 16, 8) and pc.lex_order_layout(B - 1, S) == layout
    assert st["blocks"] == B // 8 and st["stages"] == stats["stages"]
    assert st["shuffle_stages"] + st["shared_stages"] < stats["shuffle_stages"] + stats["shared_stages"]


def test_launches_refuse_cpu_tensors(lanes):
    """The launches take CUDA tensors only; the entry points send a CPU
    tensor to the plain form, never to a kernel."""
    win, mlens, moffs, length = lanes
    w, ml, mo, ln = (torch.from_numpy(a) for a in (win, mlens, moffs, length))
    ll, ol = torch.ones((4, 288), dtype=torch.int32), torch.ones((4, 32), dtype=torch.int32)
    tok = torch.ones((4, N), dtype=torch.bool)
    calls = [lambda: pc.launch_prep_lanes(ll, ol, w, ml, mo, ln),
             lambda: pc.launch_token_hist(w, ml[:, :, 0], mo[:, :, 0], tok),
             lambda: pc.launch_emit_tokens(w, ml[:, :, 0].contiguous(), mo[:, :, 0].contiguous(),
                                           ll, ll, ol, ol, tok),
             lambda: pc.launch_lex_order(ll)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# The planner with the models in place of the plain forms
# ---------------------------------------------------------------------------


def _model_forms(monkeypatch):
    """Swap the four plain forms for the kernels' models (which return
    their counters last); returns the calls made of each."""
    calls = dict.fromkeys(("prep_lanes", "token_hist", "emit_tokens", "lex_order"), 0)

    def counted(name, fn, n_out):
        def call(*args):
            calls[name] += 1
            out = fn(*args)
            return out[0] if n_out == 1 else out[:n_out]
        return call

    monkeypatch.setattr(dp_cuda, "prep_lanes_plain", counted("prep_lanes", pc.prep_lanes_model, 4))
    monkeypatch.setattr(block_torch, "token_hist_plain",
                        counted("token_hist", pc.token_hist_model, 2))
    monkeypatch.setattr(block_torch, "emit_tokens_plain",
                        counted("emit_tokens", pc.emit_tokens_model, 2))
    monkeypatch.setattr(entropy_torch, "_lex_order_plain",
                        counted("lex_order", pc.lex_order_model, 1))
    return calls


def test_planner_with_models_equals_jax(monkeypatch):
    """A seeded bucket of four 4096-position lanes (lengths 4096, 2500,
    300 and 0, the last a padded lane) cut from two 16 KiB windows, with
    the splitter's greedy marks: ``plan_block_core`` with the models
    equals ``block_jax._plan_block_core`` plus ``_emit_part``, every
    field, the words up to each lane's bits."""
    mbs = 16384
    corpus = np.frombuffer(mixed_corpus(mbs + 6000, seed=91)
                           + lz_data(mbs - 6000, seed=92, alpha=5, p_match=0.6).tobytes(),
                           np.uint8)
    lens, offs = match_tables_device_stacked(corpus, [(0, mbs), (mbs, 2 * mbs)], mbs, "cpu")
    win = np.zeros((2, HALO + mbs), np.uint8)
    win[0, HALO:] = corpus[:mbs]
    win[1, HALO - mbs :] = corpus[: 2 * mbs]
    rl = lens[:, :, 0]
    tok = chain_marks_plain(torch.where(rl >= 3, rl, 1), torch.full((2,), HALO, dtype=torch.int32),
                            torch.full((2,), HALO + mbs, dtype=torch.int32))
    meta = torch.tensor([[0, 1, 1, 0], [HALO, HALO + 100, HALO + 9000, 0],
                         [4096, 2500, 300, 0]], dtype=torch.int64)
    bucket = block_torch.slice_bucket(torch.from_numpy(win), lens, offs, meta, tok, 4096)
    calls = _model_forms(monkeypatch)
    got = block_torch.plan_block_core(*bucket)
    assert calls["prep_lanes"] == 4 and calls["token_hist"] == 5 and calls["emit_tokens"] == 1
    assert calls["lex_order"] > 0

    w, ml, mo, ln, gt = (jnp.asarray(t.numpy()) for t in bucket)
    core = block_jax._plan_block_core(w, ml, mo, ln, 4096, gt)
    words, total_bits = block_jax._emit_part(
        w, core["best_len"], core["best_off"], core["lit_cw"], core["lit_len_f"],
        core["off_cw"], core["off_len_f"], ln, core["emit_tok"], 4096)
    for key in ("is_dynamic", "lit_len", "off_len", "best_mask", "cl_len", "n_lit", "n_off"):
        _eq(core[key], got[key], key)
    _eq(total_bits, got["total_bits"], "total_bits")
    _eq(np.asarray(words).astype(np.int64), got["words"], "words")
    assert bool(np.asarray(core["is_dynamic"])[:3].any())
