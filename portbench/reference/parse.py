"""Copy of zultra_tpu/parse.py (the JAX package's NumPy-only reference
semantics), part of the benchmark's plain reference encoder. It imports
only numpy, the standard library and its sibling copies.

Optimal parse (cost DP), greedy/final entropy accounting, match→literal
post-optimization and token emission.

Mirrors reference src/blockdeflate.c:95-507 exactly (costs in bits,
strict-improvement tie-breaking, truncated-length enumeration below
LEAVE_ALONE_MATCH_SIZE) so the chosen token stream is identical.

The DP (``optimize_matches``) is the hottest loop of the whole pipeline
(reference runs it 4× per dynamic block). The spec version here is a plain
backward Python/NumPy loop; vectorized fast paths live in
``zultra_tpu.native`` (C++) and ``zultra_tpu.ops`` (JAX scan).
"""

from __future__ import annotations

import numpy as np

from .bitwriter import BitWriter
from .constants import (
    LEAVE_ALONE_MATCH_SIZE,
    MATCHLEN_BASE,
    MATCHLEN_EXTRA_BITS,
    MATCHLEN_SYMBOL,
    MAX_OFFSET,
    MIN_MATCH_SIZE,
    MIN_OFFSET,
    NEODMARKERSYM,
    NMATCHES_PER_OFFSET,
    OFFSET_EXTRA_BITS,
    OFFSET_SYMBOL,
    OFFSET_BASE,
    NOFFSETSYMS,
    offset_table_index,
)
from .huffman import HuffmanEncoder


def get_literal_size(literals_encoder: HuffmanEncoder, byte: int) -> int:
    if byte < 256:
        return literals_encoder.code_length[byte]
    return 8


def get_offset_size(offset_encoder: HuffmanEncoder, offset: int) -> int:
    idx = offset - 1
    if idx < 256:
        t = idx
    elif idx < 32768:
        t = 256 + ((idx - 256) >> 7)
    else:
        return NOFFSETSYMS
    return offset_encoder.code_length[int(OFFSET_SYMBOL[t])] + int(OFFSET_EXTRA_BITS[t])


def get_offset_symbol(offset: int) -> int:
    return int(OFFSET_SYMBOL[offset_table_index(offset)])


def get_varlen_symbol(enc_len: int) -> int:
    return int(MATCHLEN_SYMBOL[min(enc_len, 255)])


def get_varlen_size(literals_encoder: HuffmanEncoder, enc_len: int) -> int:
    # The reference takes enc_len as unsigned: a negative value (a ≥40-length
    # match clamped below MIN_MATCH_SIZE at a block boundary) wraps past 255
    # and is clamped to index 255 (blockdeflate.c:216-218). Replicate.
    idx = enc_len if 0 <= enc_len <= 255 else 255
    return literals_encoder.code_length[int(MATCHLEN_SYMBOL[idx])] + int(MATCHLEN_EXTRA_BITS[idx])


def optimize_matches(
    literals_encoder: HuffmanEncoder,
    offset_encoder: HuffmanEncoder,
    window: np.ndarray,
    match_table: np.ndarray,
    best_match: np.ndarray,
    start: int,
    end: int,
) -> None:
    """Backward cost DP choosing literal vs match (with truncated lengths)
    to minimize total bit cost under the current code lengths
    (reference src/blockdeflate.c:254-323).

    ``match_table``: (≥end, NMATCHES_PER_OFFSET, 2) int32 (length, offset).
    ``best_match``: (≥end+?, 2) int32 output (length, offset) per position.
    """
    if end <= start:
        return

    lit_len = literals_encoder.code_length
    cached_varlen = [get_varlen_size(literals_encoder, i) for i in range(LEAVE_ALONE_MATCH_SIZE)]

    cost = np.zeros(end + 1, dtype=np.int64)
    cost[end] = 0
    mt = match_table
    win = window

    off_sym = OFFSET_SYMBOL
    off_extra = OFFSET_EXTRA_BITS
    off_len = offset_encoder.code_length

    for i in range(end - 1, start - 1, -1):
        best_cost = lit_len[win[i]] if win[i] < 256 else 8
        best_cost += cost[i + 1]
        best_len = 0
        best_off = 0

        row = mt[i]
        for m in range(NMATCHES_PER_OFFSET):
            length = int(row[m, 0])
            if length < MIN_MATCH_SIZE:
                break
            offset = int(row[m, 1])
            oidx = offset - 1
            if oidx >= 256:
                oidx = 256 + ((oidx - 256) >> 7)
            offset_size = off_len[int(off_sym[oidx])] + int(off_extra[oidx])

            match_len = length
            if i + match_len > end:
                match_len = end - i

            if length >= LEAVE_ALONE_MATCH_SIZE:
                cur = get_varlen_size(literals_encoder, match_len - MIN_MATCH_SIZE)
                cur += offset_size + cost[i + match_len]
                if best_cost > cur:
                    best_cost = cur
                    best_len = match_len
                    best_off = offset
            else:
                for k in range(match_len, MIN_MATCH_SIZE - 1, -1):
                    cur = cached_varlen[k - MIN_MATCH_SIZE] + offset_size + cost[i + k]
                    if best_cost > cur:
                        best_cost = cur
                        best_len = k
                        best_off = offset

        cost[i] = best_cost
        best_match[i, 0] = best_len
        best_match[i, 1] = best_off


def accumulate_token_entropy(
    literals_encoder: HuffmanEncoder,
    offset_encoder: HuffmanEncoder,
    window: np.ndarray,
    lengths,
    offsets,
    start: int,
    end: int,
) -> None:
    """Walk a token stream described by per-position (length, offset) arrays
    and accumulate symbol histograms + the EOD marker. Used both for the
    initial greedy entropy over match_table[:,0] (reference
    src/blockdeflate.c:333-361) and the final entropy over best_match
    (:371-400). Like the reference, a match crossing ``end`` is counted in
    full and the walk simply steps past the boundary."""
    lit_ent = literals_encoder.entropy
    off_ent = offset_encoder.entropy
    i = start
    while i < end:
        length = int(lengths[i])
        if length >= MIN_MATCH_SIZE:
            lit_ent[get_varlen_symbol(length - MIN_MATCH_SIZE)] += 1
            off_ent[get_offset_symbol(int(offsets[i]))] += 1
            i += length
        else:
            byte = int(window[i])
            if byte < 256:
                lit_ent[byte] += 1
            i += 1
    lit_ent[NEODMARKERSYM] += 1


def post_optimize(
    literals_encoder: HuffmanEncoder,
    offset_encoder: HuffmanEncoder,
    window: np.ndarray,
    best_match: np.ndarray,
    start: int,
    end: int,
) -> None:
    """Demote matches that encode larger than their bytes as literals
    (reference src/blockdeflate.c:410-458)."""
    lit_len = literals_encoder.code_length
    i = start
    while i < end:
        length = int(best_match[i, 0])
        if length >= MIN_MATCH_SIZE:
            offset = int(best_match[i, 1])
            start_idx = i
            i += length
            if offset < MIN_OFFSET or offset > MAX_OFFSET:
                continue

            match_cost = get_varlen_size(literals_encoder, length - MIN_MATCH_SIZE)
            match_cost += get_offset_size(offset_encoder, offset)

            literals_cost = 0
            undefined = False
            for j in range(length):
                if literals_cost >= match_cost:
                    break
                cur = lit_len[int(window[start_idx + j])]
                if cur == 0:
                    # Symbol absent from the table: keep the match.
                    undefined = True
                    break
                literals_cost += cur

            if undefined:
                continue
            if literals_cost < match_cost:
                best_match[start_idx : start_idx + length, 0] = 0
        else:
            i += 1


def write_tokens(
    literals_encoder: HuffmanEncoder,
    offset_encoder: HuffmanEncoder,
    window: np.ndarray,
    best_match: np.ndarray,
    start: int,
    end: int,
    writer: BitWriter,
) -> None:
    """Emit the chosen token stream + EOD marker
    (reference src/blockdeflate.c:471-507)."""
    i = start
    while i < end:
        length = int(best_match[i, 0])
        if length >= MIN_MATCH_SIZE:
            offset = int(best_match[i, 1])
            if offset < MIN_OFFSET or offset > MAX_OFFSET:
                raise ValueError("invalid match offset")
            enc_len = length - MIN_MATCH_SIZE
            lidx = min(enc_len, 255)
            literals_encoder.write_codeword(int(MATCHLEN_SYMBOL[lidx]), writer)
            writer.put_bits(enc_len - int(MATCHLEN_BASE[lidx]), int(MATCHLEN_EXTRA_BITS[lidx]))

            oidx = offset_table_index(offset)
            offset_encoder.write_codeword(int(OFFSET_SYMBOL[oidx]), writer)
            writer.put_bits(offset - int(OFFSET_BASE[oidx]), int(OFFSET_EXTRA_BITS[oidx]))
            i += length
        else:
            byte = int(window[i])
            if byte >= 256:
                raise ValueError("invalid literal")
            literals_encoder.write_codeword(byte, writer)
            i += 1
    literals_encoder.write_codeword(NEODMARKERSYM, writer)
