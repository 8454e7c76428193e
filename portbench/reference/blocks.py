"""Copy of zultra_tpu/blocks.py (the JAX package's NumPy-only reference
semantics), part of the benchmark's plain reference encoder. It imports
only numpy, the standard library and its sibling copies.

Block-level logic: static/dynamic cost evaluation, entropy-drift block
splitting, and the per-block deflate routine with its convergence loop.

Mirrors reference src/blockdeflate.c:519-997 decision-for-decision:
* greedy-parse cost evaluation for static vs dynamic choice,
* libdeflate-style recursive drift splitting with left+right vs whole
  dynamic-cost comparison (18-bucket token histogram, checkpoints every
  ≥256 tokens and ≥512 bytes, 45% drift trigger, depth <6, min 8 KB),
* the 3+1-pass parse/entropy/code convergence loop, the ≥2-offset-codes
  zlib workaround, Zopfli RLE histogram A/B test, and the CL-code mask
  search (masks 0..7 then odd 9..31, later mask wins cost ties).
"""

from __future__ import annotations

import numpy as np

from .bitwriter import BitWriter
from .constants import (
    MAX_CODES_MASK,
    MIN_MATCH_SIZE,
    NCODELENBITS,
    NCODELENSYMS,
    NEODMARKERSYM,
    NLITERALSYMS,
    NMATCHLENSYMS,
    NMATCHLENSYMSTART,
    NOFFSETSYMS,
    NVALIDLITERALSYMS,
    NVALIDOFFSETSYMS,
    REV_MATCHLEN_SYMBOL_BITS,
    REV_OFFSET_SYMBOL_BITS,
    static_literal_code_lengths,
    static_offset_code_lengths,
)
from .huffman import (
    HuffmanEncoder,
    get_var_lengths_size,
    make_tables_encoder,
    optimize_histogram_for_rle,
    update_var_lengths_entropy,
    write_var_lengths,
)
from .parse import (
    accumulate_token_entropy,
    optimize_matches,
    post_optimize,
    write_tokens,
)

# The 3 + 1 parse/entropy passes of a dynamic block (reference
# src/blockdeflate.c:871-920). The control (portbench/control.py) lowers it.
CONVERGENCE_PASSES = 3


def make_block_encoders():
    return HuffmanEncoder(NLITERALSYMS, 15, 0), HuffmanEncoder(NOFFSETSYMS, 15, 0)


def prepare_cost_evaluation(window, match_table, start: int, size: int):
    """Fresh encoders with greedy-parse entropy over [start, start+size)
    (reference src/blockdeflate.c:519-527)."""
    literals_encoder, offset_encoder = make_block_encoders()
    accumulate_token_entropy(
        literals_encoder,
        offset_encoder,
        window,
        match_table[:, 0, 0],
        match_table[:, 0, 1],
        start,
        start + size,
    )
    return literals_encoder, offset_encoder


def evaluate_static_cost(literals_encoder: HuffmanEncoder, offset_encoder: HuffmanEncoder) -> int:
    """(reference src/blockdeflate.c:538-566)"""
    static_lens = static_literal_code_lengths()
    cost = 0
    for i in range(NMATCHLENSYMSTART):
        cost += literals_encoder.entropy[i] * int(static_lens[i])
    for i in range(NMATCHLENSYMSTART, NMATCHLENSYMSTART + NMATCHLENSYMS):
        cost += literals_encoder.entropy[i] * (
            int(static_lens[i]) + int(REV_MATCHLEN_SYMBOL_BITS[i - NMATCHLENSYMSTART])
        )
    for i in range(NOFFSETSYMS):
        cost += offset_encoder.entropy[i] * (5 + int(REV_OFFSET_SYMBOL_BITS[i]))
    return cost + 3


def evaluate_dynamic_cost(literals_encoder: HuffmanEncoder, offset_encoder: HuffmanEncoder) -> int:
    """Data cost under current code lengths + full dynamic table cost
    (reference src/blockdeflate.c:577-618). Code lengths may be the
    unlimited estimates; the CL-table walk clamps to 15 like the
    reference."""
    cost = 0
    for i in range(NMATCHLENSYMSTART):
        cost += literals_encoder.entropy[i] * literals_encoder.code_length[i]
    for i in range(NMATCHLENSYMSTART, NMATCHLENSYMSTART + NMATCHLENSYMS):
        cost += literals_encoder.entropy[i] * (
            literals_encoder.code_length[i] + int(REV_MATCHLEN_SYMBOL_BITS[i - NMATCHLENSYMSTART])
        )
    for i in range(NOFFSETSYMS):
        cost += offset_encoder.entropy[i] * (
            offset_encoder.code_length[i] + int(REV_OFFSET_SYMBOL_BITS[i])
        )

    n_literal_syms = literals_encoder.get_defined_var_lengths_count(257)
    n_offset_syms = offset_encoder.get_defined_var_lengths_count(1)
    code_lengths = (
        literals_encoder.code_length[:n_literal_syms] + offset_encoder.code_length[:n_offset_syms]
    )

    tables_encoder = make_tables_encoder()
    update_var_lengths_entropy(tables_encoder, n_literal_syms + n_offset_syms, code_lengths, 7)
    tables_encoder.estimate_dynamic_codelens()

    cost += 5 + 5 + 4
    cost += NCODELENBITS * tables_encoder.get_raw_table_size()
    cost += get_var_lengths_size(
        tables_encoder, n_literal_syms + n_offset_syms, code_lengths, MAX_CODES_MASK
    )
    return cost + 3


def _estimated_dynamic_cost_of_entropy(literals_encoder, offset_encoder):
    literals_encoder.estimate_dynamic_codelens()
    offset_encoder.estimate_dynamic_codelens()
    return evaluate_dynamic_cost(literals_encoder, offset_encoder)


def _split_recursive(window, match_table, start, size, depth, max_splits, splits):
    """(reference src/blockdeflate.c:634-786)"""
    if len(splits) >= max_splits:
        return
    if depth >= 6 or size < 8192:
        return

    literals_encoder, offset_encoder = prepare_cost_evaluation(window, match_table, start, size)
    total_dynamic_cost = _estimated_dynamic_cost_of_entropy(literals_encoder, offset_encoder)
    total_lit_entropy = list(literals_encoder.entropy)
    total_off_entropy = list(offset_encoder.entropy)

    left_lit, left_off = make_block_encoders()
    right_lit, right_off = make_block_encoders()

    stat = [0] * 18
    new_stat = [0] * 18
    n_stats = 0
    n_new_stats = 0
    last_good_split_idx = -1
    last_left_end = start
    best_split = start + size
    best_delta = 0

    lengths = match_table[:, 0, 0]
    i = start
    end = start + size
    while i < end:
        length = int(lengths[i])
        if length >= MIN_MATCH_SIZE:
            new_stat[17 if length >= 9 else 16] += 1
            n_new_stats += 1
            i += length
        else:
            byte = int(window[i])
            new_stat[((byte >> 4) & 0xC) | (byte & 0x3)] += 1
            n_new_stats += 1
            i += 1

        if n_new_stats >= 256 and (i - start) >= 512:
            if n_stats:
                total_delta = 0
                for j in range(18):
                    expected = stat[j] * n_new_stats
                    actual = new_stat[j] * n_stats
                    total_delta += abs(expected - actual)

                if (total_delta // n_new_stats) >= (n_stats * 45 // 100) and last_good_split_idx >= 0:
                    # Distribution drifted: evaluate a split at the last
                    # good checkpoint using incremental left/right entropy.
                    seg_lit, seg_off = prepare_cost_evaluation(
                        window, match_table, last_left_end, last_good_split_idx - last_left_end
                    )
                    for j in range(NLITERALSYMS):
                        left_lit.entropy[j] += seg_lit.entropy[j]
                    for j in range(NOFFSETSYMS):
                        left_off.entropy[j] += seg_off.entropy[j]
                    left_lit.entropy[NEODMARKERSYM] = 1

                    for j in range(NLITERALSYMS):
                        right_lit.entropy[j] = total_lit_entropy[j] - left_lit.entropy[j]
                    for j in range(NOFFSETSYMS):
                        right_off.entropy[j] = total_off_entropy[j] - left_off.entropy[j]
                    right_lit.entropy[NEODMARKERSYM] = 1

                    left_cost = _estimated_dynamic_cost_of_entropy(left_lit, left_off)
                    right_cost = _estimated_dynamic_cost_of_entropy(right_lit, right_off)
                    delta = total_dynamic_cost - (left_cost + right_cost)
                    if delta >= 0:
                        if best_split == start + size or best_delta < delta:
                            best_split = last_good_split_idx
                            best_delta = delta

                    last_left_end = last_good_split_idx

            for j in range(18):
                n_stats += new_stat[j]
                stat[j] += new_stat[j]
                new_stat[j] = 0
            n_new_stats = 0
            last_good_split_idx = i

    if best_split != start + size:
        _split_recursive(window, match_table, start, best_split - start, depth + 1, max_splits, splits)
        if len(splits) < max_splits:
            splits.append(best_split)
        _split_recursive(
            window, match_table, best_split, (size + start) - best_split, depth + 1, max_splits, splits
        )


def block_split(window, match_table, start: int, size: int, max_splits: int):
    """Returns the list of block end offsets (ascending), final entry =
    start+size (reference src/blockdeflate.c:800-813)."""
    splits: list[int] = []
    _split_recursive(window, match_table, start, size, 0, max_splits - 1, splits)
    if len(splits) < max_splits:
        splits.append(start + size)
    return splits


def block_deflate(
    window: np.ndarray,
    match_table: np.ndarray,
    best_match: np.ndarray,
    start: int,
    size: int,
    is_dynamic: bool,
    writer: BitWriter,
) -> None:
    """Compress one block: pick final tokens + tables and emit everything
    after the caller's BFINAL/BTYPE bits (reference src/blockdeflate.c:827-997)."""
    literals_encoder, offset_encoder = make_block_encoders()
    end = start + size

    if not is_dynamic:
        literals_encoder.code_length[:NLITERALSYMS] = [int(x) for x in static_literal_code_lengths()]
        offset_encoder.code_length[:NOFFSETSYMS] = [int(x) for x in static_offset_code_lengths()]
        literals_encoder.build_static_codewords()
        offset_encoder.build_static_codewords()
        optimize_matches(
            literals_encoder, offset_encoder, window, match_table, best_match, start, end
        )
    else:
        convergence_passes = CONVERGENCE_PASSES

        accumulate_token_entropy(
            literals_encoder, offset_encoder, window,
            match_table[:, 0, 0], match_table[:, 0, 1], start, end,
        )
        literals_encoder.build_dynamic_codewords()
        offset_encoder.build_dynamic_codewords()

        for pass_idx in range(convergence_passes + 1):
            # Give unused codewords a default cost so the optimizer may
            # choose to start using them.
            for i in range(NLITERALSYMS):
                if literals_encoder.code_length[i] == 0:
                    literals_encoder.code_length[i] = 9
            for i in range(NOFFSETSYMS):
                if offset_encoder.code_length[i] == 0:
                    offset_encoder.code_length[i] = 6

            optimize_matches(
                literals_encoder, offset_encoder, window, match_table, best_match, start, end
            )

            for i in range(NLITERALSYMS):
                literals_encoder.entropy[i] = 0
            for i in range(NOFFSETSYMS):
                offset_encoder.entropy[i] = 0
            accumulate_token_entropy(
                literals_encoder, offset_encoder, window,
                best_match[:, 0], best_match[:, 1], start, end,
            )

            if pass_idx == convergence_passes:
                # Always emit ≥2 offset codewords (zlib < 1.2.1.1 inflate
                # bug workaround, reference src/blockdeflate.c:893-913).
                n_offset_lens = 0
                for i in range(NOFFSETSYMS - 2):
                    if n_offset_lens >= 2:
                        break
                    if offset_encoder.entropy[i]:
                        n_offset_lens += 1
                if n_offset_lens == 0:
                    offset_encoder.entropy[0] = offset_encoder.entropy[1] = 1
                elif n_offset_lens == 1:
                    if offset_encoder.entropy[0]:
                        offset_encoder.entropy[1] = 1
                    else:
                        offset_encoder.entropy[0] = 1

            literals_encoder.build_dynamic_codewords()
            offset_encoder.build_dynamic_codewords()

        post_optimize(literals_encoder, offset_encoder, window, best_match, start, end)

        # A/B test: does the Zopfli RLE histogram rewrite give a smaller
        # tables+data total?
        opt_lit = literals_encoder.copy()
        opt_off = offset_encoder.copy()
        cur_total_cost = evaluate_dynamic_cost(opt_lit, opt_off)
        optimize_histogram_for_rle(NLITERALSYMS, opt_lit.entropy)
        optimize_histogram_for_rle(NOFFSETSYMS, opt_off.entropy)
        opt_lit.build_dynamic_codewords()
        opt_off.build_dynamic_codewords()
        opt_total_cost = evaluate_dynamic_cost(opt_lit, opt_off)
        if opt_total_cost < cur_total_cost:
            literals_encoder = opt_lit
            offset_encoder = opt_off

        n_literal_syms = literals_encoder.get_defined_var_lengths_count(257)
        n_offset_syms = offset_encoder.get_defined_var_lengths_count(1)
        code_lengths = (
            literals_encoder.code_length[:n_literal_syms]
            + offset_encoder.code_length[:n_offset_syms]
        )

        # CL-code mask search: masks 0..7 then odd masks up to 31; later
        # masks win ties (>= comparison).
        tables_encoder = make_tables_encoder()
        best_tables_cost = 0
        best_mask = -1
        mask = 0
        while mask <= MAX_CODES_MASK:
            update_var_lengths_entropy(
                tables_encoder, n_literal_syms + n_offset_syms, code_lengths, mask
            )
            tables_encoder.build_dynamic_codewords()
            cur_cost = get_var_lengths_size(
                tables_encoder, n_literal_syms + n_offset_syms, code_lengths, mask
            )
            if best_mask == -1 or best_tables_cost >= cur_cost:
                best_mask = mask
                best_tables_cost = cur_cost
            for i in range(NCODELENSYMS):
                tables_encoder.entropy[i] = 0
            mask = mask + 2 if mask >= 7 else mask + 1

        update_var_lengths_entropy(
            tables_encoder, n_literal_syms + n_offset_syms, code_lengths, best_mask
        )
        tables_encoder.build_dynamic_codewords()

        n_codelen_syms = tables_encoder.get_raw_table_size()
        if (
            n_literal_syms > NVALIDLITERALSYMS
            or n_offset_syms > NVALIDOFFSETSYMS
            or n_codelen_syms > NCODELENSYMS
        ):
            raise ValueError("invalid table sizes")
        writer.put_bits(n_literal_syms - 257, 5)
        writer.put_bits(n_offset_syms - 1, 5)
        writer.put_bits(n_codelen_syms - 4, 4)
        tables_encoder.write_raw_table(NCODELENBITS, n_codelen_syms, writer)
        write_var_lengths(
            tables_encoder, n_literal_syms + n_offset_syms, code_lengths, best_mask, writer
        )

    write_tokens(literals_encoder, offset_encoder, window, best_match, start, end, writer)
