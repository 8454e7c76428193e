"""The constant tables of the block planner and the splitter, one copy a
device.

The cost functions, the DP's lane preparation and the CL-mask search read
small constant tables: the RFC 1951 fixed code lengths and codewords, the
extra bits of the length and offset symbols, the code-length symbols'
transmission order, the mask search's order and the length-symbol map. A
host-to-device copy of a pageable array makes the host wait until the
stream has drained, and a CUDA graph capture refuses it. So each table is
copied to a device once, the first time the device asks, outside any
capture (a program's first call runs eagerly before it is captured), and
every later call looks it up here.
"""

from __future__ import annotations

import threading
import types

import numpy as np
import torch

from ..constants import (
    CODELEN_SYM_ORDER,
    MATCHLEN_EXTRA_BITS,
    MATCHLEN_SYMBOL,
    NLITERALSYMS,
    NOFFSETSYMS,
    REV_MATCHLEN_SYMBOL_BITS,
    REV_OFFSET_SYMBOL_BITS,
    static_literal_code_lengths,
    static_offset_code_lengths,
)
from ..huffman import HuffmanEncoder

# The CL-code masks in the reference's search order (0..7, then odd
# 9..31); later masks win cost ties.
MASK_ORDER = tuple(list(range(8)) + list(range(9, 32, 2)))

_on_device: dict = {}  # (device type, index) -> SimpleNamespace of tensors
_lock = threading.Lock()


def _host_tables() -> dict:
    lit = HuffmanEncoder(NLITERALSYMS, 15, 0)
    lit.code_length[:NLITERALSYMS] = [int(x) for x in static_literal_code_lengths()]
    lit.build_static_codewords()
    off = HuffmanEncoder(NOFFSETSYMS, 15, 0)
    off.code_length[:NOFFSETSYMS] = [int(x) for x in static_offset_code_lengths()]
    off.build_static_codewords()
    rev = np.asarray(REV_MATCHLEN_SYMBOL_BITS, np.int32)
    lit_extra = np.zeros(NLITERALSYMS, np.int32)
    lit_extra[257 : 257 + rev.shape[0]] = rev
    return {
        # Fixed lengths and bit-reversed codewords, from the host encoder.
        "static_lit_len": np.array(lit.code_length[:NLITERALSYMS], np.int32),
        "static_lit_cw": np.array(lit.code_word[:NLITERALSYMS], np.int32),
        "static_off_len": np.array(off.code_length[:NOFFSETSYMS], np.int32),
        "static_off_cw": np.array(off.code_word[:NOFFSETSYMS], np.int32),
        # Extra bits by literal/length and offset symbol. The reference's
        # symbol-cost loops cover 0..285 only: symbols 286 and 287 are not
        # counted (src/blockdeflate.c:577-581).
        "lit_extra": lit_extra,
        "lit_counted": np.arange(NLITERALSYMS) < 257 + rev.shape[0],
        "off_extra": np.asarray(REV_OFFSET_SYMBOL_BITS, np.int32),
        "codelen_order": np.asarray(CODELEN_SYM_ORDER, np.int64),
        "mask_order": np.asarray(MASK_ORDER, np.int32),
        "matchlen_symbol": np.asarray(MATCHLEN_SYMBOL, np.int64),
        "matchlen_extra": np.asarray(MATCHLEN_EXTRA_BITS, np.int32),
    }


def device_tables(device) -> types.SimpleNamespace:
    """Every table on ``device``, copied there on the device's first call.
    Raises if that first call comes while the current stream is captured."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.type, dev.index)
    with _lock:
        tables = _on_device.get(key)
        if tables is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the constant tables of {dev} must be copied there "
                                   "before a CUDA graph capture")
            tables = types.SimpleNamespace(**{
                name: torch.from_numpy(arr).to(dev) for name, arr in _host_tables().items()})
            _on_device[key] = tables
    return tables
