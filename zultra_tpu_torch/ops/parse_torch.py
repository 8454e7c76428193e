"""The optimal-parse cost DP with the native DP's contract: given code
lengths, a window and its match table, each position's chosen (length,
offset) over [start, end).

The counterpart of zultra_tpu/ops/parse_jax.py (``optimize_matches_jax``
:133, the scan ``_dp_scan`` :40) and of zultra_tpu/ops/parse_wavefront.py
(``optimize_matches_wavefront`` :407, the tiled fixpoint ``_dp_wavefront``
:129; ``optimize_matches_wavefront_batch`` :361, ``_dp_scan_batch`` :324,
``_dp_wavefront_batch`` :347). The scan, the tiles and the tile size are
TPU formulations of one function; the port computes it with the DP it
already has, ``dp_cuda.run_dp``: the lane preparation (K11) and the DP
kernel (B2) on the card, their plain forms on the CPU. Like the scan,
they clamp no sum, so the choices equal the scan's on every lane of up
to ``dp_cuda.MAX_LANE`` (2^21) positions; a longer block is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NLITERALSYMS, NMATCHES_PER_OFFSET, NOFFSETSYMS
from .block_torch import to_device, to_host
from .dp_cuda import run_dp


def _code_lengths(lengths, width: int) -> np.ndarray:
    """A code-length table cut or zero-padded to ``width`` symbols."""
    src = np.asarray(lengths, dtype=np.int32)[:width]
    out = np.zeros(width, np.int32)
    out[: src.shape[0]] = src
    return out


def optimize_matches_batch(jobs, device="cuda") -> list:
    """The DP of several independent blocks in one batched call. ``jobs``:
    (lit_lens, off_lens, window, match_table, start, end) tuples, each as
    ``optimize_matches`` takes them; the lanes are padded to the longest
    block. Returns one (end, 2) int32 array a job, rows below ``start``
    zero."""
    if not jobs:
        return []
    n = max(1, max(e - s for *_, s, e in jobs))
    B = len(jobs)
    lit = np.zeros((B, NLITERALSYMS), np.int32)
    off = np.zeros((B, NOFFSETSYMS), np.int32)
    wins = np.zeros((B, n), np.uint8)
    ml = np.zeros((B, n, NMATCHES_PER_OFFSET), np.int32)
    mo = np.zeros((B, n, NMATCHES_PER_OFFSET), np.int32)
    lens = np.zeros(B, np.int32)
    for b, (ll, ol, window, table, s, e) in enumerate(jobs):
        if not 0 <= s <= e:
            raise ValueError(f"optimize_matches: need 0 <= start <= end, got {s}, {e}")
        lit[b] = _code_lengths(ll, NLITERALSYMS)
        off[b] = _code_lengths(ol, NOFFSETSYMS)
        wins[b, : e - s] = np.asarray(window[s:e], np.uint8)
        t = np.asarray(table[s:e], np.int32)
        ml[b, : e - s] = t[:, :, 0]
        mo[b, : e - s] = t[:, :, 1]
        lens[b] = e - s
    dev = torch.device(device)
    best_len, best_off = to_host(*run_dp(*(to_device(a, dev) for a in (lit, off, wins, ml, mo,
                                                                       lens))))
    outs = []
    for b, (*_, s, e) in enumerate(jobs):
        out = np.zeros((e, 2), np.int32)
        out[s:e, 0] = best_len[b, : e - s]
        out[s:e, 1] = best_off[b, : e - s]
        outs.append(out)
    return outs


def optimize_matches(lit_lens, off_lens, window, match_table, start: int, end: int,
                     device="cuda") -> np.ndarray:
    """The native DP's contract (zn_optimize_matches): literal/length and
    offset code lengths, the window bytes, its (>= end, 8, 2) match table
    of (length, offset) rows, and the block [start, end). Returns an (end,
    2) int32 array of each position's chosen (length, offset), 0 for a
    literal, rows below ``start`` zero."""
    [out] = optimize_matches_batch([(lit_lens, off_lens, window, match_table, start, end)],
                                   device)
    return out
