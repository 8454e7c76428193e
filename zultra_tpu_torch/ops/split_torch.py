"""Entropy-drift block splitter over a batch of window lanes.

Port of zultra_tpu.ops.split_jax (``_token_structure``, ``_split_kernel``
and its batched form ``_split_kernel_batch``) with the lane dimension
written out. The recursion of the reference splitter (zultra
src/blockdeflate.c:634-813) runs level by level: checkpoints are
decision-independent (c_k = t1 + 256(k-1)), drift statistics are
differences of 18-bucket prefix sums, left/right histograms are prefix
histograms (both tables from the ``prefix_tables`` kernels of
``prefix_cuda``), and each level evaluates the MK costs of its drift-triggered
candidates in one batched ``entropy_torch.dynamic_cost`` call. With
``trig_cap`` > 0 only the first ``trig_cap`` triggers of a level are
evaluated and a lane with more sets ``ovf``; the caller then reruns
with ``trig_cap=0``, which is exact. On the card ``split_batch`` runs as
one program (``ops/programs.py``: a CUDA graph a (W, n, in_cap,
trig_cap)), as split_jax runs it as one ``jax.jit`` (:395).
``block_split`` is the per-window form over a host match table
(split_jax.block_split_jax, :459).

Out-of-range writes that the JAX package drops go to a dump column that
is cut off afterwards; out-of-range reads are clipped as JAX clips them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    MAX_SPLITS,
    MIN_MATCH_SIZE,
    NEODMARKERSYM,
    NLITERALSYMS,
    NOFFSETSYMS,
)

from . import programs
from .chain_cuda import chain_marks
from .prefix_cuda import prefix_tables
from .entropy_torch import dynamic_cost
from .symbol_map import matchlen_sym_extra_base, offset_index, offset_sym_extra_base

INF32 = 2**30
NBINS = NLITERALSYMS + NOFFSETSYMS  # 320 combined symbol bins
MAX_RANGES = 64
N_LEVELS = 6  # reference: depth >= 6 prunes
I32 = torch.int32
I64 = torch.int64


def split_bucket(n: int) -> int:
    """Padded lane size: powers of two from 8192."""
    size = 8192
    while size < n:
        size *= 2
    return size


def input_cap(in_size: int) -> int:
    """Candidate-capacity bound for ``in_size`` input bytes."""
    cap = 32768
    while cap < in_size:
        cap *= 2
    return cap


def trig_cap_for(in_cap: int) -> int:
    """Default triggered-candidate budget per level."""
    return max(64, in_cap >> 11)


def _take(x, idx):
    """x (W, N, ...) gathered at idx (W, C) along dim 1."""
    idx = idx.to(I64)
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    W, C = idx.shape
    return torch.gather(x, 1, idx[:, :, None].expand(W, C, x.shape[2]))


def _put(x, idx, val, cap):
    """x[w, idx] = val with indices >= cap dropped (x has cap columns)."""
    W = x.shape[0]
    ext = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    idx = torch.clamp(idx, max=cap).to(I64)
    if x.dim() == 2:
        ext.scatter_(1, idx, val)
    else:
        ext.scatter_(1, idx[:, :, None].expand(W, idx.shape[1], x.shape[2]), val)
    return ext[:, :cap]


def token_structure(window, row_len, row_off, is_tok):
    """Compacted greedy tokens per lane from match-table row 0 and the
    token-start marks. Returns (n_tok (W,), starts, ends, bucket, sym1,
    sym2), each (W, n) in token order, tails padded (INF / 0 / NBINS)."""
    W, n = row_len.shape
    dev = row_len.device
    idx = torch.arange(n, dtype=I32, device=dev)[None, :]
    is_match = row_len >= MIN_MATCH_SIZE
    step = torch.where(is_match, row_len, 1)
    e = torch.clamp(row_len - MIN_MATCH_SIZE, 0, 255)
    len_sym, _, _ = matchlen_sym_extra_base(e)
    off_sym, _, _ = offset_sym_extra_base(offset_index(row_off))
    byte = window.to(I32)
    sym1 = torch.where(is_match, len_sym, byte)
    sym2 = torch.where(is_match, NLITERALSYMS + off_sym, NBINS)
    bucket = torch.where(is_match, torch.where(row_len >= 9, 17, 16).to(I32),
                         ((byte >> 4) & 0xC) | (byte & 0x3))

    n_tok = is_tok.sum(dim=1, dtype=I32)
    order = torch.sort(torch.where(is_tok, idx, INF32), dim=1, stable=True)[1]
    tok_valid = idx < n_tok[:, None]
    pos_s = order.to(I32)
    starts = torch.where(tok_valid, pos_s, INF32)
    ends = torch.where(tok_valid, pos_s + torch.gather(step, 1, order), INF32)
    bucket_t = torch.where(tok_valid, torch.gather(bucket, 1, order), 0)
    sym1_t = torch.where(tok_valid, torch.gather(sym1, 1, order), 0)
    sym2_t = torch.where(tok_valid, torch.gather(sym2, 1, order), NBINS)
    return n_tok, starts, ends, bucket_t, sym1_t, sym2_t


def split_batch(win_p, rl, ro, prev: int, n_real, in_cap: int, trig_cap: int = 0):
    """Split points for every lane's range [prev, n_real[w]).

    win_p (W, n) uint8, rl/ro (W, n) int32 match-table row 0, n_real
    (W,) int32. Returns (splits (W, 64) int32 ascending with INF
    padding, n_splits (W,), tok_marks (W, n) bool, ovf (W,) bool). One
    ``split_program`` (a graph replay on the card, keyed on W, n,
    ``in_cap`` and ``trig_cap``)."""
    start = torch.full((rl.shape[0],), prev, dtype=I32, device=rl.device)
    return programs.run(split_program, win_p, rl, ro, start, n_real, in_cap=in_cap,
                        trig_cap=trig_cap)


def split_program(win_p, rl, ro, start, n_real, *, in_cap: int, trig_cap: int):
    """``split_batch`` with each lane's range start ``start`` (W,) int32 a
    tensor, so that one program serves every start."""
    W, n = rl.shape
    dev = rl.device
    step = torch.where(rl >= MIN_MATCH_SIZE, rl, 1)
    tok_marks = chain_marks(step, start, n_real)
    n_tok, starts, ends, bucket_t, sym1_t, sym2_t = token_structure(win_p, rl, ro, tok_marks)
    tok_iota = torch.arange(n, dtype=I32, device=dev)[None, :]
    tok_valid = tok_iota < n_tok[:, None]

    # P18 (W, n + 1, 18): 18-bucket counts over tokens [0..t] at row t + 1;
    # P256 (W, n_q, NBINS): symbol counts over tokens [0, 256q).
    P18, P256 = prefix_tables(bucket_t, sym1_t, sym2_t, n_tok)
    n_q = n // 256 + 2

    ends_sorted = torch.where(tok_valid, ends, INF32)
    j256 = torch.arange(256, dtype=I32, device=dev)

    def prefix_hist_incl(tok_idx):
        """Symbol histogram over tokens [0, tok_idx] inclusive per lane;
        tok_idx (W, C) may be -1. -> (W, C, NBINS)."""
        C = tok_idx.shape[1]
        x = tok_idx + 1
        q = x // 256
        h = _take(P256, torch.clamp(q, 0, n_q - 1))
        t_part = (q * 256)[:, :, None] + j256
        m = (t_part < x[:, :, None]) & (t_part < n_tok[:, None, None])
        t_safe = torch.clamp(t_part, 0, n - 1).reshape(W, C * 256)
        s1 = torch.where(m, _take(sym1_t, t_safe).view(W, C, 256), NBINS)
        s2 = torch.where(m, _take(sym2_t, t_safe).view(W, C, 256), NBINS)
        part = torch.zeros((W, C, NBINS + 1), dtype=I32, device=dev)
        one = torch.ones_like(s1)
        part.scatter_add_(2, s1.to(I64), one)
        part.scatter_add_(2, s2.to(I64), one)
        return h + part[:, :, :NBINS]

    C_cap = in_cap // 256 + MAX_RANGES
    rng_iota = torch.arange(MAX_RANGES, dtype=I32, device=dev)[None, :].expand(W, MAX_RANGES)
    cand_slot = torch.arange(C_cap, dtype=I32, device=dev)[None, :].expand(W, C_cap)

    zero_r = torch.zeros((W, MAX_RANGES), dtype=I32, device=dev)
    r_bs = zero_r.clone()
    r_bs[:, 0] = start
    r_be = zero_r.clone()
    r_be[:, 0] = n_real
    r_ts = zero_r.clone()
    r_te = zero_r.clone()
    r_te[:, 0] = n_tok
    r_act = torch.zeros((W, MAX_RANGES), dtype=torch.bool, device=dev)
    r_act[:, 0] = True
    n_ranges = torch.ones(W, dtype=I32, device=dev)
    splits = torch.full((W, MAX_SPLITS), INF32, dtype=I32, device=dev)
    n_splits = torch.zeros(W, dtype=I32, device=dev)
    ovf = torch.zeros(W, dtype=torch.bool, device=dev)

    hte0 = prefix_hist_incl(torch.clamp(r_te[:, :1], 1, n) - 1)  # (W, 1, NBINS)
    r_Hts = torch.zeros((W, MAX_RANGES, NBINS), dtype=I32, device=dev)
    r_Hte = r_Hts.clone()
    r_Hte[:, 0] = hte0[:, 0]
    htot0 = hte0[:, 0].clone()
    htot0[:, NEODMARKERSYM] += 1
    r_cost = zero_r.clone()
    r_cost[:, 0] = dynamic_cost(htot0[:, :NLITERALSYMS], htot0[:, NLITERALSYMS:])

    for _ in range(N_LEVELS):
        eligible = r_act & ((r_be - r_bs) >= 8192)
        t_byte = torch.searchsorted(ends_sorted, r_bs + 512, side="left").to(I32)
        t1 = torch.maximum(r_ts + 255, t_byte)
        n_cand = torch.where(eligible & (t1 < r_te), (r_te - t1 + 255) // 256, 0)

        # Flatten candidates: range id by scatter + running max.
        offs = torch.cumsum(n_cand, dim=1, dtype=I32) - n_cand
        total_c = offs[:, -1] + n_cand[:, -1]
        starts_slot = torch.where(n_cand > 0, offs, C_cap)
        rng_at = torch.full((W, C_cap + 1), -1, dtype=I32, device=dev).scatter_reduce_(
            1, torch.clamp(starts_slot, max=C_cap).to(I64), rng_iota, "amax")[:, :C_cap]
        cand_rng = torch.clamp(torch.cummax(rng_at, dim=1)[0], min=0)
        slot_valid = cand_slot < total_c[:, None]
        run_start = torch.cummax(torch.where(rng_at >= 0, cand_slot, 0), dim=1)[0]
        cand_j = cand_slot - run_start
        ck = torch.clamp(_take(t1, cand_rng) + 256 * cand_j, 0, n - 1)
        pi = ck - 256
        drift_ok = slot_valid & (cand_j >= 1)

        # Drift statistics from P18 prefixes (n_new is always 256).
        ts_c = _take(r_ts, cand_rng)
        pi_s = torch.clamp(pi, 0, n - 1)
        p18_pi = _take(P18, pi_s + 1)
        stat = p18_pi - _take(P18, torch.clamp(ts_c, 0, n))
        new = _take(P18, ck + 1) - p18_pi
        n_stats = pi - ts_c + 1
        total_delta = (stat * 256 - new * n_stats[:, :, None]).abs().sum(dim=2, dtype=I32)
        trigger = drift_ok & ((total_delta // 256) >= (n_stats * 45 // 100))

        if trig_cap > 0:
            Kc = min(trig_cap, C_cap)
            okey = torch.where(trigger, cand_slot, C_cap + cand_slot)
            sel = torch.sort(okey, dim=1)[0][:, :Kc]
            real = sel < C_cap
            sel = torch.where(real, sel, sel - C_cap)
            ovf = ovf | (trigger.sum(dim=1, dtype=I32) > Kc)
            pi_l = _take(pi_s, sel)
            rng_l = _take(cand_rng, sel)
            slot_l = sel
            lane_iota = torch.arange(Kc, dtype=I32, device=dev)[None, :].expand(W, Kc)
        else:
            Kc = C_cap
            real = trigger
            pi_l = pi_s
            rng_l = cand_rng
            slot_l = cand_slot
            lane_iota = cand_slot

        H_pi = prefix_hist_incl(pi_l)
        H_tot = _take(r_Hte - r_Hts, rng_l)
        H_tot[:, :, NEODMARKERSYM] += 1
        H_left = H_pi - _take(r_Hts, rng_l)
        H_left[:, :, NEODMARKERSYM] = 1
        H_right = H_tot - H_left
        H_right[:, :, NEODMARKERSYM] = 1
        both = torch.cat([H_left, H_right], dim=1).reshape(W * 2 * Kc, NBINS)
        costs = dynamic_cost(both[:, :NLITERALSYMS], both[:, NLITERALSYMS:]).view(W, 2 * Kc)
        left_cost = costs[:, :Kc]
        right_cost = costs[:, Kc:]
        delta = _take(r_cost, rng_l) - (left_cost + right_cost)
        good = real & (delta >= 0)
        key = torch.where(good, delta, -1)

        # Per-range best: max delta, earliest candidate on ties.
        best_delta = torch.full((W, MAX_RANGES), -1, dtype=I32, device=dev).scatter_reduce_(
            1, rng_l.to(I64), key, "amax")
        bd_l = _take(best_delta, rng_l)
        is_best = good & (key == bd_l) & (bd_l >= 0)
        best_lane = torch.full((W, MAX_RANGES + 1), Kc, dtype=I32, device=dev).scatter_reduce_(
            1, torch.where(is_best, rng_l, MAX_RANGES).to(I64), lane_iota, "amin")[:, :MAX_RANGES]
        found = best_lane < Kc

        bl_safe = torch.clamp(best_lane, 0, Kc - 1)
        bs_safe = torch.clamp(_take(slot_l, bl_safe), 0, C_cap - 1)
        pi_b = _take(pi, bs_safe)
        sp_tok = pi_b + 1
        sp_byte = _take(ends, torch.clamp(pi_b, 0, n - 1))
        Hpi_b = _take(H_pi, bl_safe)
        lc_b = _take(left_cost, bl_safe)
        rc_b = _take(right_cost, bl_safe)

        found_i = found.to(I32)
        rank = torch.cumsum(found_i, dim=1, dtype=I32) - found_i
        n_found = found_i.sum(dim=1, dtype=I32)
        splits = _put(splits, torch.where(found, n_splits[:, None] + rank, MAX_SPLITS),
                      sp_byte, MAX_SPLITS)
        n_splits = n_splits + n_found

        # Right child appends at a fresh slot; the parent slot becomes
        # the left child; parents without a split stop recursing.
        new_slot = torch.where(found, n_ranges[:, None] + rank, MAX_RANGES)
        r_bs = _put(r_bs, new_slot, sp_byte, MAX_RANGES)
        r_be = _put(r_be, new_slot, r_be, MAX_RANGES)
        r_ts = _put(r_ts, new_slot, sp_tok, MAX_RANGES)
        r_te = _put(r_te, new_slot, r_te, MAX_RANGES)
        r_act = _put(r_act, new_slot, torch.ones_like(r_act), MAX_RANGES)
        r_Hts = _put(r_Hts, new_slot, Hpi_b, MAX_RANGES)
        r_Hte = _put(r_Hte, new_slot, r_Hte, MAX_RANGES)
        r_cost = _put(r_cost, new_slot, rc_b, MAX_RANGES)

        pf = (rng_iota < n_ranges[:, None]) & found
        r_be = torch.where(pf, sp_byte, r_be)
        r_te = torch.where(pf, sp_tok, r_te)
        r_Hte = torch.where(pf[:, :, None], Hpi_b, r_Hte)
        r_cost = torch.where(pf, lc_b, r_cost)
        r_act = torch.where(rng_iota < n_ranges[:, None], found, r_act)
        n_ranges = n_ranges + n_found

    return torch.sort(splits, dim=1)[0], n_splits, tok_marks, ovf


def block_split(window, table, prev: int, in_size: int, device="cuda") -> list:
    """Block end offsets of one window from its host match table
    (``table`` (n, 8, 2), n >= prev + in_size): ascending, the last
    ``prev + in_size``. A one-lane ``split_batch`` with the same overflow
    retry as split_jax.block_split_jax (:459-492)."""
    dev = torch.device(device)
    n = prev + in_size
    n_pad = split_bucket(n)
    mt = np.asarray(table, dtype=np.int32)
    win_p = np.zeros((1, n_pad), np.uint8)
    win_p[0, :n] = np.asarray(window, dtype=np.uint8)[:n]
    rows = np.zeros((2, 1, n_pad), np.int32)
    rows[:, 0, :n] = mt[:n, 0, :].T
    win_t = torch.from_numpy(win_p).to(dev)
    rl, ro = torch.from_numpy(rows).to(dev)
    n_real = torch.tensor([n], dtype=I32, device=dev)
    cap = input_cap(in_size)
    splits, n_splits, _, ovf = split_batch(win_t, rl, ro, prev, n_real, cap, trig_cap_for(cap))
    if bool(ovf[0]):
        # Exact retry: more triggers than the compact budget.
        splits, n_splits, _, _ = split_batch(win_t, rl, ro, prev, n_real, cap, 0)
    out = [int(x) for x in splits[0, : int(n_splits[0])].cpu()]
    out.append(n)
    return out
