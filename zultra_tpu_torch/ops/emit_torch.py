"""Token emission for one block: the DEFLATE bit packing without a
sequential bit writer.

Port of zultra_tpu/ops/emit_jax.py (``write_tokens_jax``, :121). The
construction is the JAX package's:

  1. token starts of the chosen parse, p -> p + max(len_p, 1) from
     ``start``;
  2. two emission lanes a token (literal/length codeword + length extra
     bits, offset codeword + offset extra bits), each at most 32 bits,
     value = codeword | extra << len, and the end-of-data codeword last;
  3. bit offsets by one exclusive prefix sum of the lane lengths
     (DEFLATE is LSB-first, so concatenation order is stream order);
  4. packing: each lane adds its value into at most two 32-bit words
     (bit ranges are disjoint, so add == or).

The JAX form finds the token starts by pointer doubling, a TPU
workaround; here they come from the chain kernel
(``chain_cuda.chain_marks``, ``csrc/chain.cu``), which computes the
same marks. Steps 2-4 are the planner's own ``block_torch.emit_tokens``,
which packs into int64 words (torch has no uint32 ``scatter_add``); the
words are narrowed to uint32 at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MIN_MATCH_SIZE, NLITERALSYMS, NOFFSETSYMS
from .block_torch import emit_tokens
from .chain_cuda import chain_marks

I32 = torch.int32


def write_tokens(window, best, start: int, end: int, lit_encoder, off_encoder,
                 device="cuda"):
    """Packed LSB-first token bitstream of block [start, end) at bit
    phase 0 and its EOD codeword. Returns (bytes, total_bits), equal to a
    BitWriter emitting the same tokens.

    ``best``: (end, 2) int32 (length, offset) of the chosen parse;
    ``lit_encoder``/``off_encoder``: HuffmanEncoder-likes with built
    (bit-reversed) ``code_word`` and ``code_length``."""
    dev = torch.device(device)
    window = np.asarray(window, dtype=np.uint8)[:end]
    best = np.asarray(best, dtype=np.int32)[:end]
    win = torch.from_numpy(window.copy()).to(dev)[None]
    best_t = torch.from_numpy(np.ascontiguousarray(best.T)).to(dev)
    best_len, best_off = best_t[0:1], best_t[1:2]
    step = torch.where(best_len >= MIN_MATCH_SIZE, best_len, 1).contiguous()
    is_tok = chain_marks(step, torch.tensor([start], dtype=I32, device=dev),
                         torch.tensor([end], dtype=I32, device=dev))

    def table(values, size):
        """The first ``size`` entries, zero-padded: the (1, 288) and (1, 32)
        tables ``emit_tokens`` takes (it reads no symbol past 285 or 29)."""
        row = [int(v) for v in values][:size]
        return torch.tensor(row + [0] * (size - len(row)), dtype=I32, device=dev)[None]

    words, total_bits = emit_tokens(
        win, best_len, best_off, table(lit_encoder.code_word, NLITERALSYMS),
        table(lit_encoder.code_length, NLITERALSYMS), table(off_encoder.code_word, NOFFSETSYMS),
        table(off_encoder.code_length, NOFFSETSYMS), is_tok)
    total_bits = int(total_bits[0])
    nbytes = (total_bits + 7) // 8
    raw = words[0].cpu().numpy().astype(np.uint32).view(np.uint8)[:nbytes].copy()
    if total_bits & 7:
        raw[-1] &= (1 << (total_bits & 7)) - 1
    return raw.tobytes(), total_bits
