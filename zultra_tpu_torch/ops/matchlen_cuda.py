"""Match lengths of (pos, prev) pairs (kernel ``csrc/matchlen.cu``) and
their plain PyTorch version.

The counterpart of zultra_tpu/ops/matchlen.py (``match_lengths_pallas``):
for each pair, the length of the common prefix of data[pos:] and
data[prev:], counted up to min(n - pos, n - prev, 259) (0 when that cap
is not positive) and then clamped to MAX_MATCH_SIZE (258). So pos == prev
gives min(cap, 258), and a run of 259 or more equal bytes gives 258. The
TPU kernel's 256-pair tiles and its 128-aligned, zero-padded loads were
TPU layout, not semantics, and are not carried over. Positions are meant
to lie in [0, n); a pair with a negative index gets 0 here (the TPU
kernel's load is undefined there).
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import MAX_MATCH_SIZE

SPAN = MAX_MATCH_SIZE + 1  # bytes compared per pair at most
PLAIN_CHUNK = 16384  # pairs gathered at once by the plain form

launches = 0  # kernel launches since the last reset


def _check(data: torch.Tensor, positions: torch.Tensor, prev_positions: torch.Tensor) -> None:
    if data.dim() != 1 or positions.dim() != 1 or prev_positions.shape != positions.shape:
        raise ValueError("matchlen: data (n,), positions and prev_positions (P,) expected")


def match_lengths(data: torch.Tensor, positions: torch.Tensor,
                  prev_positions: torch.Tensor) -> torch.Tensor:
    """data (n,) uint8, positions / prev_positions (P,) int32 -> (P,)
    int32 match lengths."""
    global launches
    _check(data, positions, prev_positions)
    if data.device.type == "cpu":
        return match_lengths_plain(data, positions, prev_positions)
    _build.check_cuda("matchlen data", data, torch.uint8, 1)
    _build.check_cuda("matchlen positions", positions, torch.int32, 1)
    _build.check_cuda("matchlen prev_positions", prev_positions, torch.int32, 1)
    out = torch.empty(positions.shape, dtype=torch.int32, device=data.device)
    if out.numel() == 0:
        return out
    _build.launch("zt_matchlen", data.data_ptr(), data.numel(), positions.data_ptr(),
                  prev_positions.data_ptr(), out.data_ptr(), positions.numel())
    launches += 1
    return out


def match_lengths_plain(data: torch.Tensor, positions: torch.Tensor,
                        prev_positions: torch.Tensor) -> torch.Tensor:
    """Gather the (pairs, 259) byte spans a chunk at a time, compare them,
    and take the first mismatch (or the cap)."""
    _check(data, positions, prev_positions)
    n = data.numel()
    dev = data.device
    out = torch.zeros(positions.shape, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    k = torch.arange(SPAN, dtype=torch.int64, device=dev)
    for lo in range(0, positions.numel(), PLAIN_CHUNK):
        p = positions[lo : lo + PLAIN_CHUNK].to(torch.int64)
        q = prev_positions[lo : lo + PLAIN_CHUNK].to(torch.int64)
        cap = torch.clamp(n - torch.maximum(p, q), 0, SPAN)
        cap = torch.where((p < 0) | (q < 0), 0, cap)
        ia = torch.clamp(p[:, None] + k, 0, n - 1)
        ib = torch.clamp(q[:, None] + k, 0, n - 1)
        stop = (data[ia] != data[ib]) | (k >= cap[:, None])
        # A row with cap SPAN and SPAN equal bytes has no stop; one
        # always-true column at k = SPAN gives it length SPAN (-> 258).
        stop = torch.cat([stop, torch.ones((stop.shape[0], 1), dtype=torch.bool, device=dev)], 1)
        first = torch.argmax(stop.to(torch.int32), dim=1)
        out[lo : lo + PLAIN_CHUNK] = torch.clamp(first, max=MAX_MATCH_SIZE).to(torch.int32)
    return out
