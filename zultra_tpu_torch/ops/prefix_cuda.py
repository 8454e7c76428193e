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

The kernel makes three launches a call over tiles of TILE rows of P18,
aligned to TILE in the table's flat row index w (n + 1) + t + 1 (a lane's
first and last tile cut at its ends): ``count`` sums each tile's bucket
and symbol counts of its tokens below n_tok into a scratch row; ``scan``
turns a lane's scratch rows into exclusive sums in place and writes the
lane's totals after them; ``write`` takes a tile's offsets, writes its
rows of P256 (a row a stride that ends in the tile) and, a warp a run of
256 rows, each group of 32 rows of P18 computed in parallel (the warps'
bucket counts first, then base_k + popc(ballot(bucket == k) &
lanemask_le)), staged in shared memory and stored over whole lines.
``prefix_tables_model`` is that schedule in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NLITERALSYMS, NOFFSETSYMS
from .. import _build
from . import count_launch

NBINS = NLITERALSYMS + NOFFSETSYMS  # 320 combined symbol bins
NB = 18  # drift buckets
COLS = NB + NBINS  # a scratch row: a tile's bucket and symbol counts
STRIDE = 256  # tokens a row of P256 advances
TILE = 2048  # rows of P18 a tile (csrc/prefix.cu)
WARPS = 8  # warps a block of the write launch
GROUP = 32  # rows a warp computes and stores at once
I32 = torch.int32
I64 = torch.int64
MODEL_COUNTERS = ("tiles", "valid_tiles", "tokens_counted", "line_groups", "row_groups",
                  "constant_groups", "p18_rows", "p256_rows")


def tiles_per_lane(n: int) -> int:
    """Tiles a lane of n tokens touches at most (the grid's width)."""
    return -(-(n + 1) // TILE) + 1


def prefix_tables(bucket_t: torch.Tensor, sym1_t: torch.Tensor, sym2_t: torch.Tensor,
                  n_tok: torch.Tensor):
    """(P18 (W, n + 1, 18), P256 (W, n // 256 + 2, 320)) int32. A CPU
    tensor takes the plain form; a CUDA tensor one call of three launches
    (count, scan, write)."""
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
    P18 = torch.empty((W, n + 1, NB), dtype=I32, device=dev)
    P256 = torch.empty((W, n_q, NBINS), dtype=I32, device=dev)
    scratch = torch.empty((W, tiles_per_lane(n) + 1, COLS), dtype=I32, device=dev)
    if W:
        _build.launch("zt_prefix_tables", bucket_t.data_ptr(), sym1_t.data_ptr(),
                      sym2_t.data_ptr(), n_tok.data_ptr(), P18.data_ptr(), P256.data_ptr(),
                      scratch.data_ptr(), W, n)
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


def _tile(w: int, x: int, n: int):
    """Tile x of lane w as ``tile_of`` cuts it: (frame, r0, r1, a, b),
    flat rows [r0, r1), tokens [a, b), frame the TILE-aligned row its
    warps count from."""
    L0 = w * (n + 1)
    frame = (L0 // TILE + x) * TILE
    r0, r1 = max(L0, frame), min(L0 + n + 1, frame + TILE)
    return frame, r0, r1, r0 - L0 - 1, r1 - L0 - 1


def _valid_tiles(w: int, n: int, nt: int) -> int:
    """Tiles 0.. of lane w that hold a token below nt."""
    L0 = w * (n + 1)
    return (L0 + nt) // TILE - L0 // TILE + 1 if nt > 0 else 0


def prefix_tables_model(bucket_t, sym1_t, sym2_t, n_tok):
    """The kernels' schedule on CPU tensors -> (P18, P256, {counter: count}
    over ``MODEL_COUNTERS``). count: each tile that holds a token below
    n_tok sums its tokens' bucket and symbol counts into its scratch row.
    scan: a lane's scratch rows become exclusive sums, its totals the row
    after the last tile. write: each tile takes its offsets (a tile past
    n_tok the totals), writes the P256 rows whose stride ends in it (the
    lane's last tile up to n_q - 1) as running sums of its symbols by
    stride, and, a warp a run of 256 flat rows, the warp's bucket counts,
    the warps before it, then each group of 32 rows: staged unless the
    stage already holds the constant row of a group with no token, stored
    as whole lines when the group lies inside the tile, else row by row.
    Asserts that every row of both tables is written exactly once."""
    bucket = bucket_t.numpy()
    s1 = sym1_t.numpy()
    s2 = sym2_t.numpy()
    W, n = bucket.shape
    n_q = n // STRIDE + 2
    NX = tiles_per_lane(n)
    P18 = np.zeros((W * (n + 1), NB), np.int64)
    P256 = np.zeros((W, n_q, NBINS), np.int64)
    scratch = np.zeros((W, NX + 1, COLS), np.int64)
    p18_done = np.zeros(W * (n + 1), np.int64)
    p256_done = np.zeros((W, n_q), np.int64)
    stats = dict.fromkeys(MODEL_COUNTERS, 0)
    nts = [max(min(int(v), n), 0) for v in n_tok]

    for w in range(W):  # count
        for x in range(_valid_tiles(w, n, nts[w])):
            _, r0, r1, a, b = _tile(w, x, n)
            assert r0 < r1
            lo, hi = max(a, 0), min(b, nts[w])
            stats["tokens_counted"] += max(hi - lo, 0)
            scratch[w, x] = np.concatenate([_bins(bucket[w, lo:hi], NB),
                                            _bins(s1[w, lo:hi], NBINS) + _bins(s2[w, lo:hi], NBINS)])
    for w in range(W):  # scan
        v = _valid_tiles(w, n, nts[w])
        sums = np.cumsum(scratch[w, :v], axis=0)
        scratch[w, NX] = sums[-1] if v else 0
        scratch[w, :v] = sums - scratch[w, :v]

    for w in range(W):  # write
        nt = nts[w]
        L0 = w * (n + 1)
        v = _valid_tiles(w, n, nt)
        for x in range(NX):
            frame, r0, r1, a, b = _tile(w, x, n)
            if r0 >= r1:
                continue
            stats["tiles"] += 1
            stats["valid_tiles"] += x < v
            base = scratch[w, x if x < v else NX]
            lo, hi = max(a, 0), min(b, nt)
            rho0 = -(-(a + 1) // STRIDE)
            rho1 = n_q if b == n else -(-(b + 1) // STRIDE)
            hist = np.zeros((rho1 - rho0, NBINS), np.int64)
            tok = np.arange(lo, max(hi, lo))
            r = np.maximum(tok // STRIDE + 1 - rho0, 0)  # the first row that counts t
            for sym in (s1[w, tok], s2[w, tok]):
                keep = (r < rho1 - rho0) & (sym >= 0) & (sym < NBINS)
                np.add.at(hist, (r[keep], sym[keep]), 1)
            P256[w, rho0:rho1] = base[NB:] + np.cumsum(hist, axis=0)
            p256_done[w, rho0:rho1] += 1
            rows = np.arange(frame, frame + TILE)
            t = rows - L0 - 1
            b_rows = np.where((rows >= r0) & (rows < r1) & (t >= 0) & (t < nt),
                              bucket[w, np.clip(t, 0, n - 1)], -1)
            onehot = (b_rows[:, None] == np.arange(NB)[None, :]).astype(np.int64)
            per_warp = TILE // WARPS
            warp_counts = onehot.reshape(WARPS, per_warp, NB).sum(axis=1)
            for warp in range(WARPS):
                run = base[:NB] + warp_counts[:warp].sum(axis=0)
                constant = False
                for g in range(warp * per_warp, (warp + 1) * per_warp, GROUP):
                    G = frame + g
                    if G + GROUP <= r0 or G >= r1:
                        continue
                    any_token = bool((b_rows[g:g + GROUP] >= 0).any())
                    if any_token or not constant:
                        stage = run + np.cumsum(onehot[g:g + GROUP], axis=0)
                        run = stage[-1]
                        constant = not any_token
                    else:
                        stats["constant_groups"] += 1
                    at = np.arange(G, G + GROUP)
                    keep = (at >= r0) & (at < r1)
                    stats["line_groups" if keep.all() else "row_groups"] += 1
                    P18[at[keep]] = stage[keep]
                    p18_done[at[keep]] += 1
    assert (p18_done == 1).all() and (p256_done == 1).all()
    stats["p18_rows"] = int(p18_done.sum())
    stats["p256_rows"] = int(p256_done.sum())
    return _as_i32(P18.reshape(W, n + 1, NB)), _as_i32(P256), stats


def _as_i32(x: np.ndarray) -> torch.Tensor:
    """int64 counts wrapped to int32, as the kernels' and cumsum's adds wrap."""
    return torch.from_numpy(((x + 2**31) % 2**32 - 2**31).astype(np.int32))
