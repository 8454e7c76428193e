"""Byte histograms (kernel ``csrc/histogram.cu``) and token histograms,
with the kernel's plain PyTorch version.

The counterpart of zultra_tpu/ops/histogram.py. ``byte_histogram`` is
``byte_histogram_pallas``: the count of each byte value below
``n_symbols`` (values at or above it are not counted; bins from 256 up to
``n_symbols`` are 0), as int64. The TPU kernel cut its input at 2^24
bytes because its float32 one-hot sums are exact only that far; integer
counters need no cut, and the count is exact for any n.
``token_histogram`` is ``token_histogram_jax``, which is plain XLA in the
JAX package and so a plain torch call here.
"""

from __future__ import annotations

import torch

from .. import _build

THREADS = 256  # csrc/histogram.cu's block
MAX_BLOCKS = 132 * 8  # 8 blocks per SM of an H100 fill the card
BINS = 256

launches = 0  # kernel launches since the last reset


def _check(data: torch.Tensor, n_symbols: int) -> None:
    if data.dim() != 1:
        raise ValueError(f"byte_histogram: expected a 1-D tensor, got shape {tuple(data.shape)}")
    if n_symbols < 1:
        raise ValueError(f"byte_histogram: n_symbols {n_symbols} < 1")


def _to_symbols(counts: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """256 bins -> n_symbols bins (cut, or padded with zeros)."""
    if n_symbols <= BINS:
        return counts[:n_symbols].clone()
    return torch.nn.functional.pad(counts, (0, n_symbols - BINS))


def byte_histogram(data: torch.Tensor, n_symbols: int = 256) -> torch.Tensor:
    """data (n,) uint8 -> (n_symbols,) int64 counts of the values below
    n_symbols."""
    global launches
    _check(data, n_symbols)
    if data.device.type == "cpu":
        return byte_histogram_plain(data, n_symbols)
    _build.check_cuda("byte_histogram", data, torch.uint8, 1)
    n = data.numel()
    counts = torch.zeros(BINS, dtype=torch.int64, device=data.device)
    if n == 0:
        return _to_symbols(counts, n_symbols)
    # Enough blocks to fill the card, and enough that no block counts
    # 2^32 bytes into its 32-bit shared counters.
    blocks = max(min(-(-n // (THREADS * 16 * 8)), MAX_BLOCKS), -(-n // (1 << 31)), 1)
    _build.launch("zt_hist", data.data_ptr(), n, counts.data_ptr(), blocks)
    launches += 1
    return _to_symbols(counts, n_symbols)


def byte_histogram_plain(data: torch.Tensor, n_symbols: int = 256) -> torch.Tensor:
    """``scatter_add_`` of ones over all 256 byte values, then the bins
    below n_symbols."""
    _check(data, n_symbols)
    counts = torch.zeros(BINS, dtype=torch.int64, device=data.device)
    counts.scatter_add_(0, data.to(torch.int64), torch.ones_like(data, dtype=torch.int64))
    return _to_symbols(counts, n_symbols)


def token_histogram(symbols: torch.Tensor, n_symbols: int = 288) -> torch.Tensor:
    """symbols (n,) integer -> (n_symbols,) int32 counts of the values in
    [0, n_symbols) (a one-hot row of any other value is all zero)."""
    s = symbols.to(torch.int64)
    valid = (s >= 0) & (s < n_symbols)
    counts = torch.zeros(n_symbols + 1, dtype=torch.int32, device=symbols.device)
    counts.scatter_add_(0, torch.where(valid, s, n_symbols), torch.ones_like(s, dtype=torch.int32))
    return counts[:n_symbols]
