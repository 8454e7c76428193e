"""Byte histograms (kernel ``csrc/histogram.cu``) and token histograms,
with the kernel's plain PyTorch version and a plain model of its
schedule.

The counterpart of zultra_tpu/ops/histogram.py. ``byte_histogram`` is
``byte_histogram_pallas``: the count of each byte value below
``n_symbols`` (values at or above it are not counted; bins from 256 up to
``n_symbols`` are 0), as int64. The TPU kernel cut its input at 2^24
bytes because its float32 one-hot sums are exact only that far; integer
counters need no cut, and the count is exact for any n.
``token_histogram`` is ``token_histogram_jax``, which is plain XLA in the
JAX package and so a plain torch call here.

A call is one launch: the blocks count the body of 16-byte words in
steps of ``THREADS`` x ``UNROLL`` words (block b takes steps b, b +
grid, ...), a word of 16 equal bytes as a pending run in registers,
block 0 the unaligned head and the tail; each block adds its sums into
64-bit accumulators and takes a ticket, and the block with the last
ticket writes the result, zero bins included, and sets the accumulators
and the ticket back to 0. The wrapper keeps those 257 words a stream,
made zero once. ``byte_histogram_model`` is that schedule in numpy, with
counters; it asserts that each byte is counted once and that a block's
32-bit counters cannot overflow.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import count_launch

THREADS = 256  # csrc/histogram.cu's block
UNROLL = 4  # 16-byte words each thread loads before it counts them
STEP = THREADS * UNROLL  # words a block takes at a time
BINS = 256
MODEL_COUNTERS = ("head_bytes", "body_bytes", "tail_bytes", "run_words", "run_adds",
                  "byte_adds", "blocks_with_work")

_resident = {}  # device index -> blocks the card holds at once
_states = {}  # (device index, stream) -> the kernel's accumulators and ticket


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


def split(n: int, base_mod: int) -> tuple:
    """(head, n_vec): the bytes before the first 16-byte-aligned address
    of data at ``base_mod`` mod 16, and the 16-byte words after them."""
    head = min((16 - base_mod % 16) % 16, n)
    return head, (n - head) // 16


def grid_for(n_vec: int, resident: int) -> int:
    """Blocks for n_vec body words: one step of work each, at most the
    ``resident`` blocks the card holds at once (a larger input takes more
    steps a block), at least 1."""
    return max(1, min(resident, -(-n_vec // STEP)))


def byte_histogram(data: torch.Tensor, n_symbols: int = 256) -> torch.Tensor:
    """data (n,) uint8 -> (n_symbols,) int64 counts of the values below
    n_symbols."""
    _check(data, n_symbols)
    if data.device.type == "cpu":
        return byte_histogram_plain(data, n_symbols)
    _build.check_cuda("byte_histogram", data, torch.uint8, 1)
    n = data.numel()
    head, n_vec = split(n, data.data_ptr())
    blocks = grid_for(n_vec, _resident_blocks(data.device))
    # A block's 32-bit counters see its steps' words and, in block 0, the
    # head and tail (at most 30 bytes).
    if (-(-n_vec // (blocks * STEP)) * STEP * 16 + 30) >= 1 << 32:
        raise ValueError(f"byte_histogram: {n} bytes overflow {blocks} blocks' 32-bit counters")
    out = torch.empty(n_symbols, dtype=torch.int64, device=data.device)
    # The state is zero after each completed call, so calls in the order
    # of one stream may share it: the stream the launch goes to, the
    # current one of data's device. A launch that is refused runs nothing
    # and leaves it zero; a kernel that faults leaves the device unusable.
    with torch.cuda.device(data.device):
        key = (data.device.index, torch.cuda.current_stream().cuda_stream)
        if key not in _states:
            _states[key] = torch.zeros(BINS + 1, dtype=torch.int64, device=data.device)
        _build.launch("zt_hist", data.data_ptr(), n, head, n_vec, out.data_ptr(), n_symbols,
                      _states[key].data_ptr(), blocks)
    count_launch("hist")
    return out


def _resident_blocks(device: torch.device) -> int:
    """SMs x the blocks an SM holds at once (the occupancy API)."""
    if device.index not in _resident:
        per_sm = _build.lib().zt_hist_blocks_per_sm()
        if per_sm < 1:
            raise RuntimeError(f"zt_hist_blocks_per_sm: CUDA error {-per_sm}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[device.index] = per_sm * sms
    return _resident[device.index]


def byte_histogram_plain(data: torch.Tensor, n_symbols: int = 256) -> torch.Tensor:
    """``scatter_add_`` of ones over all 256 byte values, then the bins
    below n_symbols."""
    _check(data, n_symbols)
    counts = torch.zeros(BINS, dtype=torch.int64, device=data.device)
    counts.scatter_add_(0, data.to(torch.int64), torch.ones_like(data, dtype=torch.int64))
    return _to_symbols(counts, n_symbols)


def byte_histogram_model(data: torch.Tensor, n_symbols: int, grid: int, base_mod: int = 0):
    """The kernel's schedule on a CPU tensor placed at an address of
    ``base_mod`` mod 16, on ``grid`` blocks -> (the counts of
    ``byte_histogram_plain``, {counter: count} over ``MODEL_COUNTERS``).
    Counters: bytes counted in the head, the body and the tail;
    ``run_words`` (16 equal bytes); ``run_adds`` (a thread's pending run
    added to its warp's counters: when the run's byte changes, and once
    at the end); ``byte_adds`` (one a byte of every other word, the head
    and the tail); ``blocks_with_work``."""
    _check(data, n_symbols)
    assert grid >= 1 and 0 <= base_mod < 16
    d = data.numpy()
    n = len(d)
    counts = dict.fromkeys(MODEL_COUNTERS, 0)
    head, n_vec = split(n, base_mod)
    seen = np.zeros(n, np.int64)  # times each byte was counted
    partial = np.zeros((grid, BINS), np.int64)

    # Count: word i is loaded by thread i % THREADS of block (i // STEP) %
    # grid, in ascending i within the thread; block 0 also counts the
    # head and the bytes after the body.
    word = np.arange(n_vec)
    block = (word // STEP) % grid
    words = d[head : head + 16 * n_vec].reshape(n_vec, 16)
    seen[head : head + 16 * n_vec] += 1
    run = (words == words[:, :1]).all(axis=1)
    for b in range(grid):
        np.add.at(partial[b], words[(block == b) & ~run].ravel(), 1)
    # A thread's runs, in its order: an add where the byte changes or
    # its runs end.
    thread = block * THREADS + word % THREADS
    order = np.argsort(thread[run], kind="stable")
    r_thread, r_byte = thread[run][order], words[run, 0].astype(np.int64)[order]
    end = np.ones(r_thread.size, bool)
    end[:-1] = (r_thread[1:] != r_thread[:-1]) | (r_byte[1:] != r_byte[:-1])
    group = np.concatenate([[0], np.cumsum(end)[:-1]])
    sizes = np.bincount(group, minlength=int(end.sum())) * 16 if r_thread.size else group
    np.add.at(partial, (r_thread[end] // THREADS, r_byte[end]), sizes)
    counts["run_words"] = int(run.sum())
    counts["run_adds"] = int(end.sum())
    counts["byte_adds"] = 16 * int((~run).sum())
    counts["blocks_with_work"] = int(np.unique(block).size)
    tail = np.arange(head + 16 * n_vec, n)
    assert tail.size < 16
    edge = np.concatenate([np.arange(head), tail])
    np.add.at(partial[0], d[edge], 1)
    seen[edge] += 1
    counts["byte_adds"] += edge.size
    counts["head_bytes"], counts["body_bytes"], counts["tail_bytes"] = head, 16 * n_vec, tail.size
    assert (seen == 1).all(), "a byte counted other than once"
    assert partial.sum(axis=1).max(initial=0) < 1 << 32, "a block's 32-bit counter overflowed"

    # Finish: the blocks' sums meet in the accumulators; the last block
    # writes every bin below n_symbols.
    acc = partial.sum(axis=0)
    out = np.zeros(n_symbols, np.int64)
    out[: min(n_symbols, BINS)] = acc[:n_symbols]
    return torch.from_numpy(out), counts


def token_histogram(symbols: torch.Tensor, n_symbols: int = 288) -> torch.Tensor:
    """symbols (n,) integer -> (n_symbols,) int32 counts of the values in
    [0, n_symbols) (a one-hot row of any other value is all zero)."""
    s = symbols.to(torch.int64)
    valid = (s >= 0) & (s < n_symbols)
    counts = torch.zeros(n_symbols + 1, dtype=torch.int32, device=symbols.device)
    counts.scatter_add_(0, torch.where(valid, s, n_symbols), torch.ones_like(s, dtype=torch.int32))
    return counts[:n_symbols]
