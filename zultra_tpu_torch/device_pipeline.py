"""One-shot compression on one CUDA device: match tables -> block split
-> block plans run on the device for a batch of windows; the host
writes the framing, the table bits and the ordered splice of the packed
token words.

Port of the device half of zultra_tpu.device_pipeline
(``_begin_windows_batched``, ``compress_device``, ``DeviceWindowEngine``;
no mesh). The host half — ``emit_window_from_plan``,
``write_block_from_plan``, ``put_packed_bits`` and ``_WindowPlan`` — is
the JAX package's own numpy code, imported as it is, so window cuts,
history slides, BFINAL placement, the stored fallback and the framing
are the same code for both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from zultra_tpu import frame
from zultra_tpu.constants import HISTORY_SIZE
from zultra_tpu.device_pipeline import _WindowPlan, emit_window_from_plan
from zultra_tpu.stream import StreamError, clamp_block_size, memory_bound

from .ops.block_torch import plan_blocks_device_multi
from .ops.matchfinder_torch import HALO, match_tables_device_stacked
from .ops.split_torch import input_cap, split_batch, split_bucket, trig_cap_for

WINDOWS_PER_BATCH = 16  # windows planned together in one device batch


def begin_windows_batched(corpus: np.ndarray, spans, mbs: int, device) -> list:
    """Plan a batch of windows on ``device``. Every window occupies a
    (HALO + mbs) lane with its first input byte at offset HALO and its
    real history bytes (<= 32 KB) just below. Returns one _WindowPlan
    per span, in order."""
    W = len(spans)
    n_lane = HALO + mbs
    lens_st, offs_st = match_tables_device_stacked(corpus, spans, mbs, device)

    win_stack = np.zeros((W, n_lane), np.uint8)
    prevs = []
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = min(HISTORY_SIZE, w_lo)
        prevs.append(prev)
        win_stack[w, HALO - prev : HALO + (w_hi - w_lo)] = corpus[w_lo - prev : w_hi]
    win_dev = torch.from_numpy(win_stack).to(device)

    n_pad = split_bucket(n_lane)
    tail = n_pad - n_lane
    win_p = torch.nn.functional.pad(win_dev, (0, tail))
    rl = torch.nn.functional.pad(lens_st[:, :, 0], (0, tail))
    ro = torch.nn.functional.pad(offs_st[:, :, 0], (0, tail))
    n_real = torch.tensor([HALO + (hi - lo) for lo, hi in spans], dtype=torch.int32,
                          device=device)
    cap = input_cap(mbs)
    splits, n_splits, tok_marks, ovf = split_batch(win_p, rl, ro, HALO, n_real, cap,
                                                   trig_cap_for(cap))
    if bool(ovf.any()):
        # Exact retry of the overflowing lanes with every candidate slot
        # evaluated.
        full = split_batch(win_p, rl, ro, HALO, n_real, cap, 0)
        splits = torch.where(ovf[:, None], full[0], splits)
        n_splits = torch.where(ovf, full[1], n_splits)
    splits = splits.cpu().numpy()
    n_splits = n_splits.cpu().numpy()

    lanes = []
    spans_per_window = []
    for w, (w_lo, w_hi) in enumerate(spans):
        ends = [int(x) for x in splits[w, : int(n_splits[w])]]
        ends.append(HALO + (w_hi - w_lo))
        blocks = []
        s = HALO
        for e in ends:
            blocks.append((s, e))
            lanes.append((w, s, e - s))
            s = e
        spans_per_window.append(blocks)

    plans = plan_blocks_device_multi(win_dev, lens_st, offs_st, lanes,
                                     tok_stack=tok_marks[:, :n_lane])

    handles = []
    i = 0
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = prevs[w]
        shift = HALO - prev  # lane coords -> window-buffer coords
        blocks = [(s - shift, e - shift) for (s, e) in spans_per_window[w]]
        handles.append(_WindowPlan(plans[i : i + len(blocks)], blocks,
                                   corpus[w_lo - prev : w_hi], prev, w_hi - w_lo))
        i += len(blocks)
    return handles


def compress_device(data: bytes, flags: int = 0, max_block_size: int = 0,
                    dictionary: bytes | None = None, device="cuda") -> bytes:
    """One-shot compression with windows batched through the device
    begin-phase; byte-identical to zultra_tpu's streaming core at the
    same block size (reference one-shot API, src/libzultra.c:601-619)."""
    device = torch.device(device)
    mbs = clamp_block_size(max_block_size)
    data_b = bytes(data)
    if not data_b:
        raise StreamError("cannot finalize an empty stream")
    dict_b = bytes(dictionary) if dictionary else b""
    if len(dict_b) > HISTORY_SIZE:
        raise StreamError(f"dictionary exceeds the {HISTORY_SIZE}-byte history window")
    corpus = np.frombuffer(dict_b + data_b, dtype=np.uint8)
    base = len(dict_b)
    spans = []
    pos = 0
    while pos < len(data_b):
        hi = min(pos + mbs, len(data_b))
        spans.append((base + pos, base + hi))
        pos = hi

    out = bytearray(frame.encode_header(flags, dict_b if dict_b else None))
    checksum = frame.update_checksum(frame.init_checksum(flags), corpus[base:], flags)
    buf = bytearray(memory_bound(mbs, flags, mbs))
    bits_data, bits_count = 0, 0
    for g in range(0, len(spans), WINDOWS_PER_BATCH):
        group = spans[g : g + WINDOWS_PER_BATCH]
        for i, handle in enumerate(begin_windows_batched(corpus, group, mbs, device)):
            is_last = g + i + 1 == len(spans)
            n, bits_data, bits_count = emit_window_from_plan(
                handle, is_last, buf, bits_data, bits_count)
            out += buf[:n]
    out += frame.encode_footer(flags, checksum, len(data_b))
    return bytes(out)


class DeviceWindowEngine:
    """Engine for zultra_tpu's ``Stream``: one-shot compression goes
    through ``compress_device``; the per-window contract plans each
    window alone through ``begin_windows_batched``. Attach it with
    ``stream.engine = DeviceWindowEngine(device)``."""

    name = "torchdev"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def compress_corpus(self, data, flags=0, max_block_size=0, dictionary=None):
        return compress_device(data, flags, max_block_size, dictionary, device=self.device)

    def begin_window(self, window: np.ndarray, prev: int, in_size: int,
                     n_threads: int = 0) -> _WindowPlan:
        window = np.asarray(window, dtype=np.uint8)
        n = prev + in_size
        if prev > HALO:
            raise ValueError("a window carries at most 32 KB of history")
        # One span whose history is exactly the window's own prefix: the
        # corpus is the window itself.
        [handle] = begin_windows_batched(window[:n], [(prev, n)], in_size, self.device)
        return handle

    def emit_window(self, handle: _WindowPlan, window_is_last: bool, out: bytearray,
                    bits_data: int, bits_count: int):
        return emit_window_from_plan(handle, window_is_last, out, bits_data, bits_count)

    def free_window(self, handle: _WindowPlan) -> None:
        pass
