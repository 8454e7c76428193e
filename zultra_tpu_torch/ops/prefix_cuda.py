"""The block splitter's prefix tables (kernels ``csrc/prefix.cu``), their
plain PyTorch version, and the plain model of the kernels' schedule.

Over each lane's compacted greedy tokens (``split_torch.token_structure``:
bucket_t, sym1_t, sym2_t (W, n) int32 in token order, n_tok (W,)):
- ``P18`` (W, n + 1, 18): the 18-bucket counts with a leading zero row,
  P18[w, t + 1, k] = tokens <= t of bucket k;
- ``P256`` (W, n // 256 + 2, 320): P256[w, q] = the sym1 and sym2 counts
  of the tokens [0, 256 q).
Tokens at or past n_tok count nowhere (the plain form sends them to the
drop bin NBINS, split_jax.py:190-191). The JAX package builds both with
``jnp.cumsum`` inside the jitted splitter (split_jax.py:176-193); the
plain form here is the same construction in torch (a one-hot of (W, n,
18) and two outer-dimension cumsums).

The kernel makes two launches a call, chunked by SPC = 128 strides of 256
tokens (32768 tokens a chunk): ``count`` writes each stride's histogram
as its row of P256 and each chunk's 18 bucket and 320 symbol counts to a
scratch row; ``write`` sums the scratch rows before its chunk, scans its
rows of P256 in place, and walks its tokens a warp at a time (32 * SPC
tokens a warp, 8 warps a chunk), lane k writing bucket k's running count
to every row of P18. ``prefix_tables_model`` is that schedule in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NLITERALSYMS, NOFFSETSYMS
from .. import _build
from . import count_launch

NBINS = NLITERALSYMS + NOFFSETSYMS  # 320 combined symbol bins
NB = 18  # drift buckets
STRIDE = 256  # tokens a row of P256 advances
WARPS = 8  # warps a block of the write launch (csrc/prefix.cu THREADS / 32)
SPC = 128  # strides a chunk
I32 = torch.int32
I64 = torch.int64
MODEL_COUNTERS = ("chunks", "strides", "warps", "tokens_counted", "p18_rows", "p256_rows")


def prefix_tables(bucket_t: torch.Tensor, sym1_t: torch.Tensor, sym2_t: torch.Tensor,
                  n_tok: torch.Tensor):
    """(P18 (W, n + 1, 18), P256 (W, n // 256 + 2, 320)) int32. A CPU
    tensor takes the plain form; a CUDA tensor one call of two launches."""
    if bucket_t.device.type == "cpu":
        return prefix_tables_plain(bucket_t, sym1_t, sym2_t, n_tok)
    for name, t in (("bucket_t", bucket_t), ("sym1_t", sym1_t), ("sym2_t", sym2_t)):
        _build.check_cuda(f"prefix_tables {name}", t, I32, 2)
    _build.check_cuda("prefix_tables n_tok", n_tok, I32, 1)
    W, n = bucket_t.shape
    if sym1_t.shape != (W, n) or sym2_t.shape != (W, n) or n_tok.shape != (W,):
        raise ValueError("prefix_tables: inconsistent input shapes")
    if not 1 <= n < 1 << 30:
        raise ValueError(f"prefix_tables: lanes of {n} tokens, the kernel takes 1..2^30 - 1")
    dev = bucket_t.device
    n_q = n // STRIDE + 2
    nc = -(-(n_q - 1) // SPC)
    P18 = torch.empty((W, n + 1, NB), dtype=I32, device=dev)
    P256 = torch.empty((W, n_q, NBINS), dtype=I32, device=dev)
    scratch = torch.empty((W, nc, NB + NBINS), dtype=I32, device=dev)
    if W:
        _build.launch("zt_prefix_tables", bucket_t.data_ptr(), sym1_t.data_ptr(),
                      sym2_t.data_ptr(), n_tok.data_ptr(), P18.data_ptr(), P256.data_ptr(),
                      scratch.data_ptr(), W, n, SPC)
        count_launch("prefix_tables")
    return P18, P256


def prefix_tables_plain(bucket_t, sym1_t, sym2_t, n_tok):
    """The JAX construction in torch: a one-hot cumsum for P18, a
    scatter of every stride's symbols and a cumsum over strides for P256."""
    W, n = bucket_t.shape
    dev = bucket_t.device
    tok_iota = torch.arange(n, dtype=I32, device=dev)[None, :]
    tok_valid = tok_iota < n_tok[:, None]

    # 18-bucket inclusive prefix sums with a leading zero row:
    # P18[w, t+1] = bucket counts over tokens [0..t].
    onehot18 = ((bucket_t[:, :, None] == torch.arange(NB, dtype=I32, device=dev))
                & tok_valid[:, :, None]).to(I32)
    P18 = torch.cat([torch.zeros((W, 1, NB), dtype=I32, device=dev),
                     torch.cumsum(onehot18, dim=1, dtype=I32)], dim=1)
    del onehot18

    # Stride-256 symbol prefix table: P256[w, q] = symbol counts over
    # tokens [0, 256q). Bin NBINS is the drop bin.
    n_q = n // STRIDE + 2
    qid = tok_iota // STRIDE + 1
    row = torch.where(tok_valid, qid, n_q - 1).to(I64)
    flat = torch.zeros((W, n_q * (NBINS + 1)), dtype=I32, device=dev)
    ones = torch.ones((W, n), dtype=I32, device=dev)
    flat.scatter_add_(1, row * (NBINS + 1) + torch.where(tok_valid, sym1_t, NBINS), ones)
    s2 = torch.where(tok_valid & (sym2_t < NBINS), sym2_t, NBINS)
    flat.scatter_add_(1, row * (NBINS + 1) + s2, ones)
    P256 = torch.cumsum(flat.view(W, n_q, NBINS + 1), dim=1, dtype=I32)[:, :, :NBINS].contiguous()
    return P18, P256


def _bins(x: np.ndarray, k: int) -> np.ndarray:
    """Counts of the values of x in 0..k-1 (others dropped)."""
    x = x[(x >= 0) & (x < k)]
    return np.bincount(x, minlength=k).astype(np.int64)


def prefix_tables_model(bucket_t, sym1_t, sym2_t, n_tok):
    """The kernels' schedule on CPU tensors -> (P18, P256, {counter: count}
    over ``MODEL_COUNTERS``). The count launch: each (lane, chunk of SPC
    strides) writes its strides' histograms as raw rows of P256
    and its chunk totals to scratch. The write launch: each (lane, chunk)
    takes its offsets from the scratch rows before it, scans its raw rows
    of P256, and each of its 8 warps counts its 32 * SPC tokens, adds the
    warps before it and writes its rows of P18 in order. Asserts that
    every row of both tables is written exactly once (P256's raw rows
    once more, by the scan) and that the scan sees raw rows only."""
    bucket = bucket_t.numpy()
    s1 = sym1_t.numpy()
    s2 = sym2_t.numpy()
    W, n = bucket.shape
    n_q = n // STRIDE + 2
    n_strides = n_q - 1
    nc = -(-n_strides // SPC)
    P18 = np.zeros((W, n + 1, NB), np.int64)
    P256 = np.zeros((W, n_q, NBINS), np.int64)
    scratch = np.zeros((W, nc, NB + NBINS), np.int64)
    p18_done = np.zeros((W, n + 1), np.int64)
    p256_raw = np.zeros((W, n_q), np.int64)
    p256_done = np.zeros((W, n_q), np.int64)
    stats = dict.fromkeys(MODEL_COUNTERS, 0)

    for w in range(W):  # the count launch
        nt = max(min(int(n_tok[w]), n), 0)
        for j in range(nc):
            stats["chunks"] += 1
            c18 = np.zeros(NB, np.int64)
            tot = np.zeros(NBINS, np.int64)
            for q in range(j * SPC, min((j + 1) * SPC, n_strides)):
                stats["strides"] += 1
                lo, hi = q * STRIDE, min(q * STRIDE + STRIDE, nt)
                hist = _bins(s1[w, lo:hi], NBINS) + _bins(s2[w, lo:hi], NBINS)
                P256[w, q + 1] = hist
                p256_raw[w, q + 1] += 1
                tot += hist
                c18 += _bins(bucket[w, lo:hi], NB)
            scratch[w, j] = np.concatenate([c18, tot])

    for w in range(W):  # the write launch
        nt = max(min(int(n_tok[w]), n), 0)
        for j in range(nc):
            base = scratch[w, :j].sum(axis=0)
            if j == 0:
                P256[w, 0] = 0
                p256_done[w, 0] += 1
            acc = base[NB:].copy()
            for q in range(j * SPC, min((j + 1) * SPC, n_strides)):
                assert p256_raw[w, q + 1] == 1 and p256_done[w, q + 1] == 0
                acc += P256[w, q + 1]
                P256[w, q + 1] = acc
                p256_done[w, q + 1] += 1
            per_warp = 32 * SPC
            spans = []
            for warp in range(WARPS):
                t0 = j * SPC * STRIDE + warp * per_warp
                t1 = min(t0 + per_warp, n)
                tv = min(t1, nt)
                spans.append((t0, t1, _bins(bucket[w, t0:max(tv, t0)], NB)))
                stats["tokens_counted"] += max(tv - t0, 0)
            if j == 0:
                P18[w, 0] = 0
                p18_done[w, 0] += 1
            for warp, (t0, t1, _) in enumerate(spans):
                stats["warps"] += 1
                if t1 <= t0:
                    continue
                run = base[:NB] + sum(sp[2] for sp in spans[:warp])
                b = bucket[w, t0:t1].astype(np.int64)
                b = np.where(np.arange(t0, t1) < nt, b, -1)
                onehot = (b[:, None] == np.arange(NB)[None, :]).astype(np.int64)
                P18[w, t0 + 1:t1 + 1] = run + np.cumsum(onehot, axis=0)
                p18_done[w, t0 + 1:t1 + 1] += 1
    assert (p18_done == 1).all() and (p256_done == 1).all()
    stats["p18_rows"] = int(p18_done.sum())
    stats["p256_rows"] = int(p256_done.sum())
    return _as_i32(P18), _as_i32(P256), stats


def _as_i32(x: np.ndarray) -> torch.Tensor:
    """int64 counts wrapped to int32, as the kernels' and cumsum's adds wrap."""
    return torch.from_numpy(((x + 2**31) % 2**32 - 2**31).astype(np.int32))
