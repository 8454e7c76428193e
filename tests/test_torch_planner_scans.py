"""The planner's and splitter's scans in the port against the JAX package
on the CPU: the Zopfli RLE decision sweep (``rle_cuda.optimize_for_rle``
and the pair entry the planner calls, ``optimize_for_rle_pair``, against
``entropy_jax.optimize_for_rle_jax``), the RLE statistics of
code-length tables (``rle_histogram_masks`` / ``rle_bits_masks`` against
``entropy_jax.rle_histogram`` / ``rle_bits`` under every mask of
``MASK_ORDER``, and the CL-mask search), and the splitter's prefix tables
(``prefix_cuda.prefix_tables`` against a numpy cumsum of the JAX
splitter's token arrays, and the split points against
``split_jax._split_kernel_batch``). Each plain form and each model of a
kernel's schedule is held against JAX on numpy-seeded and edge inputs.
Every output is integer: tolerance is exact equality. Also the launch
counter under two threads."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zultra_tpu import native
from zultra_tpu.ops import entropy_jax as ej
from zultra_tpu.ops.split_jax import _split_kernel_batch, _token_structure
from zultra_tpu_torch import ops
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import entropy_torch as et
from zultra_tpu_torch.ops import prefix_cuda as pc
from zultra_tpu_torch.ops import rle_cuda as rc
from zultra_tpu_torch.ops import split_torch as st

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

MASKS = et.MASK_ORDER


def _eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.cpu().numpy(), err_msg=msg)


def _sweep_rows(L, seed):
    """Histogram rows: every edge the sweep distinguishes, then seeded
    rows of runs, near-flat stretches and spikes."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(L, np.int32)]  # all zeros: eff 0
    for eff in (1, 3, 4):
        r = np.zeros(L, np.int32)
        r[:eff] = rng.integers(1, 50, eff)
        rows.append(r)
    for zeros in (4, 5):  # a zero run of exactly 4 or 5 inside eff
        r = np.full(L, 9, np.int32)
        r[3 : 3 + zeros] = 0
        rows.append(r[:L])
    for same in (6, 7):  # a nonzero run of exactly 6 or 7
        r = rng.integers(20, 90, L).astype(np.int32)
        r[2 : 2 + same] = 40
        rows.append(r)
    rows.append(np.full(L, 7, np.int32))  # one run to the end
    ramp = (np.arange(L) % 11 + 100).astype(np.int32)  # steps below the limit of 4
    rows.append(ramp)
    big = rng.integers(0, 1 << 20, L).astype(np.int32)
    big[L // 2 :] = 0
    rows.append(big)
    for _ in range(24):
        r = np.repeat(rng.integers(0, 12, L), rng.integers(1, 9, L))[:L].astype(np.int32)
        r = np.where(rng.random(L) < 0.15, 0, r) + np.where(rng.random(L) < 0.05, 200, 0)
        r[rng.integers(L // 2, L + 1) :] = 0
        rows.append(r.astype(np.int32))
    # A boundary at every position: one good run, and steps of 99 from
    # the second position on; no boundary before eff: steps below 4 and no
    # run of 7.
    pos = np.arange(L)
    rows += [np.full(L, 9, np.int32), np.where(pos % 2, 100, 1).astype(np.int32),
             (100 + pos % 3).astype(np.int32)]
    # Totals and four-wide sums that wrap int32, and differences that do.
    top, low = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    rows += [((1 << 30) + pos % 3).astype(np.int32), (top - pos % 3).astype(np.int32),
             np.where(pos % 5 < 2, top, low).astype(np.int32),
             np.where(pos % 3 == 0, low, pos * 7).astype(np.int32)]
    return np.stack([r[:L] for r in rows])


@pytest.mark.parametrize("L", [19, 32, 288, 320])
def test_rle_sweep_plain_and_model_equal_jax(L):
    c = _sweep_rows(L, L)
    want = jax.jit(ej.optimize_for_rle_jax)(jnp.asarray(c))
    ct = torch.from_numpy(c)
    _eq(want, rc.optimize_for_rle_plain(ct), "plain")
    _eq(want, et.optimize_for_rle(ct), "entropy_torch on a CPU tensor")
    got, stats = rc.rle_sweep_model(ct)
    _eq(want, got, "model")
    assert stats["segments"] > 0 and stats["rewritten"] > 0  # rows that are rewritten
    eff = np.where(c != 0, np.arange(L) + 1, 0).max(axis=1)
    assert stats["words"] == int((-(-eff // 32)).sum())  # the chain's words below eff
    assert stats["tests"] == 32 * 32 * stats["words"]
    assert stats["doubling_rounds"] == 5 * stats["words"]
    assert stats["boundaries"] >= int((eff > 0).sum()) + L - 1  # the row of boundaries


@pytest.mark.parametrize("B", [1, 5])
def test_rle_sweep_pair_equals_two_plain_calls_and_jax(B):
    """The pair entry on CPU tensors (a planner call's (B, 288) and (B, 32)
    histograms) equals two plain calls, and the JAX sweep of each set; the
    model of each set too."""
    lit = torch.from_numpy(_sweep_rows(288, 3 + B)[:B])
    off = torch.from_numpy(_sweep_rows(32, 4 + B)[-B:])
    got = rc.optimize_for_rle_pair(lit, off)
    assert et.optimize_for_rle_pair is rc.optimize_for_rle_pair
    for g, rows in zip(got, (lit, off)):
        _eq(rc.optimize_for_rle_plain(rows).numpy(), g, "pair against a plain call")
        _eq(jax.jit(ej.optimize_for_rle_jax)(jnp.asarray(rows.numpy())), g, "pair against jax")
        _eq(g.numpy(), rc.rle_sweep_model(rows)[0], "model")


def _stats_lanes(L, seed):
    """Length rows and n_def: runs of exactly 7, 8 and 9 of one nonzero
    length (the mask bits 8 and 16 single out repeat counts 7 and 8),
    zero runs around the 3/11/138 thresholds, lengths above 15 side by
    side (distinct runs, one CL symbol), n_def 0, 1 and L, and seeded
    rows of runs."""
    rng = np.random.default_rng(seed)
    rows, n_def = [], []

    def add(parts, nd=None):
        r = np.concatenate([np.full(k, v, np.int32) for v, k in parts] + [np.zeros(L, np.int32)])
        rows.append(r[:L])
        n_def.append(L if nd is None else nd)

    for k in (7, 8, 9):
        add([(5, k), (3, 1), (6, k + 1)])
    for k in (2, 3, 10, 11, 138, 139, 149):
        add([(4, 1), (0, k), (2, 3)])
    add([(16, 3), (17, 4), (20, 8), (15, 2), (0, 5)])
    add([(8, 7)], nd=0)
    add([(8, 7)], nd=1)
    add([(0, L)])
    for _ in range(10):
        r = np.repeat(rng.integers(0, 18, L), rng.integers(1, 12, L))[:L].astype(np.int32)
        r = np.where(rng.random(L) < 0.2, 0, r)
        rows.append(r)
        n_def.append(int(rng.integers(0, L + 1)))
    return np.stack(rows), np.asarray(n_def, np.int32)


STATS_L = (19, 32, 288, 320)


@pytest.fixture(scope="module")
def stats_case():
    """The lanes of every L, their CL lengths under every mask, and the
    JAX histograms and bit sizes. JAX sees each lane once, zero-padded to
    320 entries: entries at or past n_def (<= L) take no part in either
    statistic, so padding leaves them unchanged, and one batch keeps
    the JAX side to one call a mask and function."""
    lanes = {L: _stats_lanes(L, 100 + L) for L in STATS_L}
    B = {L: lanes[L][0].shape[0] for L in STATS_L}
    te = {L: np.random.default_rng(L).integers(0, 8, (len(MASKS) * B[L], 19)).astype(np.int32)
          for L in STATS_L}
    lens = np.concatenate([np.pad(lanes[L][0], ((0, 0), (0, 320 - L))) for L in STATS_L])
    n_def = np.concatenate([lanes[L][1] for L in STATS_L])
    lj, nj = jnp.asarray(lens), jnp.asarray(n_def)
    want = {}
    for i, mask in enumerate(MASKS):
        te_m = np.concatenate([te[L][i * B[L]:(i + 1) * B[L]] for L in STATS_L])
        h = np.asarray(ej.rle_histogram(lj, nj, mask))
        b = np.asarray(ej.rle_bits(lj, nj, jnp.asarray(te_m), mask))
        at = 0
        for L in STATS_L:
            want[L, mask] = (h[at:at + B[L]], b[at:at + B[L]])
            at += B[L]
    return lanes, te, want


@pytest.mark.parametrize("L", STATS_L)
def test_rle_stats_plain_and_model_equal_jax_every_mask(stats_case, L):
    lanes, te, want = stats_case
    lens, n_def = lanes[L]
    B = lens.shape[0]
    lt, nt, tt = torch.from_numpy(lens), torch.from_numpy(n_def), torch.from_numpy(te[L])
    hists = rc.rle_histogram_masks(lt, nt, MASKS)
    bits = rc.rle_bits_masks(lt, nt, tt, MASKS)
    m_hists, _, _, h_stats = rc.rle_stats_model(lt, None, nt, MASKS)
    m_bits, *_ = rc.rle_stats_model(lt, None, nt, MASKS, tt)
    assert h_stats["rows"] == len(MASKS) * B and h_stats["runs"] > 0
    assert h_stats["lanes"] == B  # a lane's runs found once for all its masks
    for i, mask in enumerate(MASKS):
        rows = slice(i * B, (i + 1) * B)
        want_h, want_b = want[L, mask]
        _eq(want_h, hists[rows], f"plain histogram, mask {mask}")
        _eq(want_h, m_hists[rows], f"model histogram, mask {mask}")
        _eq(want_b, bits[rows], f"plain bits, mask {mask}")
        _eq(want_b, m_bits[rows], f"model bits, mask {mask}")
        _eq(want_h, et.rle_histogram(lt, nt, mask), f"entropy_torch histogram, mask {mask}")
        _eq(want_b, et.rle_bits(lt, nt, tt[rows], mask), f"entropy_torch bits, mask {mask}")


@pytest.mark.parametrize("mask", [7, 31])
def test_rle_stats_long_n_def_equal_jax(mask):
    """Rows already concatenated whose n_def passes their width: the last
    run reaches n_def, so one mask's bins can pass the packed fields'
    PACK_BITS bits (n_def 1023 still packs; 1024 and beyond take the
    __match_any_sync sum). Plain form and model (one mask, and every mask)
    against entropy_jax.rle_histogram / rle_bits."""
    rng = np.random.default_rng(mask)
    L = 320
    n_def = np.asarray([1023, 1024, 5000, 1 << 20, 7, 320], np.int32)
    lens = np.repeat(rng.integers(0, 16, (len(n_def), L)), rng.integers(1, 9, L), axis=1)[:, :L]
    lens[:, -40:] = 0  # a last run of zeros, reaching n_def
    lens[1, -40:] = 6  # a nonzero one
    te = rng.integers(0, 8, (len(n_def), 19)).astype(np.int32)
    lj, nj = jnp.asarray(lens.astype(np.int32)), jnp.asarray(n_def)
    want_h = ej.rle_histogram(lj, nj, mask)
    want_b = ej.rle_bits(lj, nj, jnp.asarray(te), mask)
    assert int(np.asarray(want_h).sum(axis=1).max()) >= 1 << rc.PACK_BITS
    lt, nt, tt = torch.from_numpy(lens.astype(np.int32)), torch.from_numpy(n_def), torch.from_numpy(te)
    _eq(want_h, rc.rle_histogram_masks(lt, nt, (mask,)), "plain histogram")
    _eq(want_b, rc.rle_bits_masks(lt, nt, tt, (mask,)), "plain bits")
    got_h, _, _, stats = rc.rle_stats_model(lt, None, nt, (mask,))
    assert stats["packed_rows"] == int((n_def < 1 << rc.PACK_BITS).sum())
    _eq(want_h, got_h, "model histogram")
    _eq(want_b, rc.rle_stats_model(lt, None, nt, (mask,), tt)[0], "model bits")
    all_h = rc.rle_stats_model(lt, None, nt, MASKS)[0]
    i = MASKS.index(mask)
    _eq(want_h, all_h[i * len(n_def):(i + 1) * len(n_def)], "model histogram, every mask")


def test_mask_search_plain_and_model_equal_jax(monkeypatch):
    rng = np.random.default_rng(7)
    lit = np.where(rng.random((12, 288)) < 0.6, rng.integers(1, 3000, (12, 288)), 0)
    off = np.where(rng.random((12, 32)) < 0.5, rng.integers(1, 300, (12, 32)), 0)
    lit[0], off[0] = 0, 0
    lit[1, :] = 0
    lit[1, 65] = 9
    llt = et.build_lengths(torch.from_numpy(lit.astype(np.int32)), 15)
    olt = et.build_lengths(torch.from_numpy(off.astype(np.int32)), 15)
    want = jax.jit(ej.mask_search)(jnp.asarray(llt.numpy()), jnp.asarray(olt.numpy()))
    for got, w in zip(et.mask_search(llt, olt), want):
        _eq(w, got, "plain")
    monkeypatch.setattr(et, "rle_histogram_tables",
                        lambda lit, off, masks: rc.rle_stats_model(lit, off, None, masks)[:3])
    monkeypatch.setattr(et, "rle_bits_tables",
                        lambda lit, off, te, masks: rc.rle_stats_model(lit, off, None, masks,
                                                                       te)[0])
    for got, w in zip(et.mask_search(llt, olt), want):
        _eq(w, got, "model")


def _table_lanes(seed):
    """Code-length tables (lit_len (B, 288), off_len (B, 32)) for the fused
    statistics: lit rows whose last nonzero is below 257, at 287 and all
    zero; off rows all zero (n_off 1) and full (32); rows with runs of 3,
    7, 11, 138 and 139 equal values (zero and nonzero, some across the
    lit/off seam); seeded rows of runs."""
    rng = np.random.default_rng(seed)
    lit, off = [], []

    def add(lit_parts, off_row):
        r = np.concatenate([np.full(k, v, np.int32) for v, k in lit_parts]
                           + [np.zeros(288, np.int32)])[:288]
        lit.append(r)
        off.append(np.asarray(off_row, np.int32))

    full_off = rng.integers(1, 16, 32)
    add([(7, 100)], np.zeros(32))  # last nonzero below 257, no offset length
    add([(0, 287), (9, 1)], full_off)  # last nonzero at 287
    add([], np.zeros(32))  # all zero: n_lit 257, n_off 1
    add([], full_off)
    for k in (3, 7, 11, 138, 139):
        add([(4, 2), (0, k), (8, k), (2, 3)], np.concatenate([np.full(k % 32, 5), np.zeros(32)])[:32])
        add([(6, 250), (0, 7 + k % 10)], np.full(32, 0 if k < 11 else 3))  # zeros across the seam
    for _ in range(12):
        r = np.repeat(rng.integers(0, 16, 288), rng.integers(1, 12, 288))[:288]
        lit.append(np.where(rng.random(288) < 0.3, 0, r).astype(np.int32))
        o = np.where(rng.random(32) < 0.4, 0, rng.integers(1, 16, 32))
        o[rng.integers(1, 33):] = 0
        off.append(o.astype(np.int32))
    return np.stack(lit), np.stack(off)


@pytest.mark.parametrize("seed", [17, 29])
def test_rle_stats_tables_plain_and_model_equal_jax(seed):
    """The fused statistics (the concatenation of lit_len and off_len in
    the kernel): the plain form and the model (all masks in one call, by
    classes; each mask alone, its bins summed packed) against
    entropy_jax._concat_lengths then rle_histogram / rle_bits under every
    mask of MASK_ORDER, with n_lit and n_off."""
    lit, off = _table_lanes(seed)
    B = lit.shape[0]
    lens, n_lit, n_off, n_def = jax.jit(ej._concat_lengths)(jnp.asarray(lit), jnp.asarray(off))
    assert set(np.asarray(n_lit)) >= {257, 288} and set(np.asarray(n_off)) >= {1, 32}
    te = np.random.default_rng(3).integers(0, 8, (len(MASKS) * B, 19)).astype(np.int32)
    lt, ot, tt = torch.from_numpy(lit), torch.from_numpy(off), torch.from_numpy(te)
    hists, p_lit, p_off = rc.rle_histogram_tables(lt, ot, MASKS)
    bits = rc.rle_bits_tables(lt, ot, tt, MASKS)
    m_hists, m_lit, m_off, stats = rc.rle_stats_model(lt, ot, None, MASKS)
    m_bits, *_ = rc.rle_stats_model(lt, ot, None, MASKS, tt)
    assert stats["lanes"] == B and stats["rows"] == len(MASKS) * B and stats["class_counts"] > 0
    for name, got in (("plain", (p_lit, p_off)), ("model", (m_lit, m_off))):
        _eq(n_lit, got[0], f"{name} n_lit")
        _eq(n_off, got[1], f"{name} n_off")
    for i, mask in enumerate(MASKS):
        rows = slice(i * B, (i + 1) * B)
        want_h = ej.rle_histogram(lens, n_def, mask)
        want_b = ej.rle_bits(lens, n_def, jnp.asarray(te[rows]), mask)
        _eq(want_h, hists[rows], f"plain histogram, mask {mask}")
        _eq(want_h, m_hists[rows], f"model histogram, mask {mask}")
        _eq(want_b, bits[rows], f"plain bits, mask {mask}")
        _eq(want_b, m_bits[rows], f"model bits, mask {mask}")
        # one mask a call: a warp a lane, every row's bins packed (n_def <= 320)
        one_h, _, _, one = rc.rle_stats_model(lt, ot, None, (mask,))
        one_b, *_ = rc.rle_stats_model(lt, ot, None, (mask,), tt[rows])
        assert one["steps"] > 0 and one["packed_rows"] == B and one["group_adds"] == 0
        _eq(want_h, one_h, f"model histogram, mask {mask} alone")
        _eq(want_b, one_b, f"model bits, mask {mask} alone")


def _numpy_prefix_tables(bucket, sym1, sym2, n_tok):
    """split_jax.py:176-193 in numpy, lane by lane."""
    W, n = bucket.shape
    n_q = n // 256 + 2
    P18 = np.zeros((W, n + 1, 18), np.int64)
    P256 = np.zeros((W, n_q, 321), np.int64)
    for w in range(W):
        valid = np.arange(n) < n_tok[w]
        onehot = (bucket[w][:, None] == np.arange(18)[None, :]) & valid[:, None]
        P18[w, 1:] = np.cumsum(onehot, axis=0)
        row = np.where(valid, np.arange(n) // 256 + 1, n_q - 1)
        np.add.at(P256[w], (row, np.where(valid, sym1[w], 320)), 1)
        np.add.at(P256[w], (row, np.where(valid & (sym2[w] < 320), sym2[w], 320)), 1)
        P256[w] = np.cumsum(P256[w], axis=0)
    return P18.astype(np.int32), P256[:, :, :320].astype(np.int32)


def _check_prefix(bucket, sym1, sym2, n_tok):
    want = _numpy_prefix_tables(bucket, sym1, sym2, n_tok)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (bucket, sym1, sym2, n_tok)]
    for name, w, g in zip(("P18", "P256"), want, pc.prefix_tables(*args)):
        _eq(w, g, f"plain {name}")
    *got, stats = pc.prefix_tables_model(*args)
    for name, w, g in zip(("P18", "P256"), want, got):
        _eq(w, g, f"model {name}")
    W, n = bucket.shape
    assert stats["p18_rows"] == W * (n + 1) and stats["p256_rows"] == W * (n // 256 + 2)
    nt = np.clip(n_tok, 0, n)
    assert stats["tokens_counted"] == int(nt.sum())
    # a tile a TILE-aligned run of the lane's flat rows; those holding a token below n_tok
    assert stats["tiles"] == sum(((w + 1) * (n + 1) - 1) // pc.TILE - w * (n + 1) // pc.TILE + 1
                                 for w in range(W))
    assert stats["valid_tiles"] == sum((w * (n + 1) + t) // pc.TILE - w * (n + 1) // pc.TILE + 1
                                       for w, t in enumerate(nt) if t > 0)
    return stats


def _window_lanes(n, seed):
    """Two windows of seeded bytes with their native match tables' row 0,
    padded to n: (win (2, n) uint8, rl, ro (2, n) int32, n_real (2,))."""
    sizes = (n - 1000, n // 2 + 77)
    win = np.zeros((2, n), np.uint8)
    rl = np.zeros((2, n), np.int32)
    ro = np.zeros((2, n), np.int32)
    for w, size in enumerate(sizes):
        data = np.frombuffer(mixed_corpus(size // 2, seed=seed + w)
                             + lz_data(size - size // 2, seed=seed + 9, alpha=6).tobytes(),
                             np.uint8)[:size]
        table = native.build_match_table(np.ascontiguousarray(data), 0).astype(np.int32)
        win[w, :size] = data
        rl[w, :size] = table[:, 0, 0]
        ro[w, :size] = table[:, 0, 1]
    return win, rl, ro, np.asarray(sizes, np.int32)


def test_prefix_tables_equal_numpy_of_jax_tokens():
    """The JAX splitter's token arrays of two windows (n = 8192), their
    tables by a numpy cumsum, against the port's plain form and model;
    the port's token arrays equal JAX's."""
    n = 8192
    win, rl, ro, n_real = _window_lanes(n, 21)
    structure = jax.jit(_token_structure, static_argnames=("n",))
    jt = [[np.asarray(a) for a in structure(jnp.asarray(win[w]), jnp.asarray(rl[w]),
                                            jnp.asarray(ro[w]), 0, int(n_real[w]), n)]
          for w in range(2)]
    n_tok, _, _, bucket, sym1, sym2 = (np.stack([lane[k] for lane in jt]) for k in range(6))
    assert 0 < n_tok[1] < n_tok[0] < n
    marks = st.chain_marks(torch.from_numpy(np.where(rl >= 3, rl, 1).astype(np.int32)),
                           torch.zeros(2, dtype=torch.int32), torch.from_numpy(n_real))
    port = st.token_structure(torch.from_numpy(win), torch.from_numpy(rl),
                              torch.from_numpy(ro), marks)
    for k, name in ((0, "n_tok"), (3, "bucket"), (4, "sym1"), (5, "sym2")):
        _eq(np.stack([lane[k] for lane in jt]), port[k], name)
    _check_prefix(bucket, sym1, sym2, n_tok.astype(np.int32))


CHUNK = 32768  # tokens a chunk of the kernel before tiles (a lane of many tiles)
TILE = pc.TILE  # rows of P18 a tile


@pytest.mark.parametrize("n,n_tok", [(8192, (0, 512, 8192)), (1000, (1000, 256, 999)),
                                     (256, (256, 255, 0)),
                                     (2 * CHUNK + 1000, (2 * CHUNK + 1000, 2 * CHUNK, CHUNK,
                                                         CHUNK - 1, CHUNK + 1)),
                                     (3 * TILE - 1, (3 * TILE - 1, TILE - 2, TILE - 1, TILE)),
                                     (2 * TILE, (TILE - 1, TILE, TILE + 1)),
                                     (2 * TILE + 1, (0, 1, 2 * TILE + 1)),
                                     (1, (1, 0, 1))])
def test_prefix_tables_edge_lanes(n, n_tok):
    """No token, tokens ending on a stride boundary of 256, every position
    a token, a lane not a multiple of 256, a lane of one stride; a lane of
    many tiles with tokens ending on, before and after a chunk boundary.
    Tiles are aligned in the flat row index w (n + 1) + t + 1: with n + 1
    a multiple of TILE (n = 3 TILE - 1) every lane starts a tile, else
    (W = 3, n even and odd) the lanes' heads and tails cut tiles; tokens
    ending on, before and after a tile's rows (the last row of tile 0 of
    lane 0 is token TILE - 2), and lanes of one token."""
    rng = np.random.default_rng(n)
    W = len(n_tok)
    bucket = rng.integers(0, 18, (W, n))
    sym1 = rng.integers(0, 286, (W, n))
    sym2 = np.where(rng.random((W, n)) < 0.4, rng.integers(288, 318, (W, n)), 320)
    stats = _check_prefix(bucket, sym1, sym2, np.asarray(n_tok, np.int32))
    if n + 1 > TILE and (n + 1) % TILE:
        assert stats["row_groups"] > 0  # a lane's head or tail stored row by row
    if n >= TILE:
        assert stats["line_groups"] > 0  # groups inside a tile stored as whole lines


def test_split_points_with_prefix_model_equal_jax(monkeypatch):
    """split_batch on two windows against _split_kernel_batch: with the
    prefix tables' plain form, then with the kernels' schedule model."""
    n = 16384
    win, rl, ro, n_real = _window_lanes(n, 31)
    in_cap = st.input_cap(n)
    trig_cap = st.trig_cap_for(in_cap)
    want = _split_kernel_batch(jnp.asarray(win), jnp.asarray(rl), jnp.asarray(ro), jnp.int32(0),
                               jnp.asarray(n_real), n, in_cap, trig_cap=trig_cap)
    args = (torch.from_numpy(win), torch.from_numpy(rl), torch.from_numpy(ro), 0,
            torch.from_numpy(n_real), in_cap, trig_cap)
    names = ("splits", "n_splits", "tok_marks", "ovf")
    for name, w, g in zip(names, want, st.split_batch(*args)):
        _eq(w, g, f"plain {name}")
    assert int(np.asarray(want[1]).sum()) > 0  # the windows are split
    monkeypatch.setattr(st, "prefix_tables",
                        lambda *a: pc.prefix_tables_model(*a)[:2])
    for name, w, g in zip(names, want, st.split_batch(*args)):
        _eq(w, g, f"model {name}")


def test_launch_counts_are_whole_under_threads():
    """Threads adding launches at once (two, and more threads than cores,
    with the interpreter switching threads as often as it can) lose none;
    a reset zeroes every kernel's count; a CPU tensor launches nothing."""
    per_thread = 5000

    def bump():
        for _ in range(per_thread):
            ops.count_launch("rle_stats")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for n_threads in (2, (os.cpu_count() or 1) + 1):
            ops.reset_launch_counts()
            threads = [threading.Thread(target=bump) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert ops.launch_counts()["rle_stats"] == n_threads * per_thread
    finally:
        sys.setswitchinterval(interval)
    assert set(ops.launch_counts()) == set(ops.KERNEL_NAMES)
    ops.reset_launch_counts()
    rc.optimize_for_rle(torch.from_numpy(_sweep_rows(32, 1)))
    rc.optimize_for_rle_pair(torch.from_numpy(_sweep_rows(288, 1)),
                             torch.from_numpy(_sweep_rows(32, 1)))
    assert all(v == 0 for v in ops.launch_counts().values())
