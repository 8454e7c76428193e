"""Host Huffman pieces of the splice: canonical codewords from given code
lengths, the raw code-length table, and the RLE-coded literal/offset
length table (reference src/huffman/huffencoder.c:348-372 and
:446-735).

Copy of the part of zultra_tpu/huffman.py that the host splice and the
static tables need — ``HuffmanEncoder`` without its histogram and
length construction (the device computes the lengths), and
``write_var_lengths`` with its run walk — so that the port imports
nothing of zultra_tpu. Decisions and tie-breaks are unchanged.
"""

from __future__ import annotations

from .bitwriter import BitWriter
from .constants import CODELEN_SYM_ORDER, MAX_SYMBOLS


def _sorted_by_value_then_index(values, indices):
    """Ascending by (values[idx], idx) — the total order produced by the
    reference's index qsort (huffencoder.c:34-61)."""
    return sorted(indices, key=lambda idx: (values[idx], idx))


def _reverse_bits16(word: int, nbits: int) -> int:
    w = ((word & 0x5555) << 1) | ((word & 0xAAAA) >> 1)
    w = ((w & 0x3333) << 2) | ((w & 0xCCCC) >> 2)
    w = ((w & 0x0F0F) << 4) | ((w & 0xF0F0) >> 4)
    w = ((w & 0x00FF) << 8) | ((w & 0xFF00) >> 8)
    return w >> (16 - nbits)


class HuffmanEncoder:
    """One Huffman alphabet: code lengths and canonical codewords."""

    __slots__ = ("n_symbols", "max_code_length", "code_word", "code_length")

    def __init__(self, n_symbols: int, max_code_length: int, default_code_length: int = 0):
        if not (0 <= n_symbols <= MAX_SYMBOLS) or not (0 <= max_code_length <= 32):
            raise ValueError("invalid huffman encoder parameters")
        self.n_symbols = n_symbols
        self.max_code_length = max_code_length
        self.code_word = [0] * MAX_SYMBOLS
        self.code_length = [default_code_length] * n_symbols + [0] * (MAX_SYMBOLS - n_symbols)

    def _issue_canonical(self, order) -> None:
        """Issue canonical codewords (bit-reversed) over symbols listed in
        (length, index) ascending order."""
        if not order:
            return
        word = 0
        length = self.code_length[order[0]]
        for pos, sym in enumerate(order):
            self.code_word[sym] = _reverse_bits16(word, length)
            if pos + 1 < len(order):
                next_length = self.code_length[order[pos + 1]]
                word = (word + 1) << (next_length - length)
                length = next_length

    def build_static_codewords(self) -> None:
        """Canonical codewords over ALL symbols (static tables)."""
        order = _sorted_by_value_then_index(self.code_length, list(range(self.n_symbols)))
        self._issue_canonical(order)

    def write_codeword(self, symbol: int, writer: BitWriter) -> None:
        if not (0 <= symbol < self.n_symbols):
            raise ValueError(f"symbol {symbol} out of range")
        writer.put_bits(self.code_word[symbol], self.code_length[symbol])

    def get_raw_table_size(self) -> int:
        """Number of CL-alphabet entries that must be transmitted
        (trailing zero-length entries in transmission order are dropped,
        minimum 4)."""
        i = self.n_symbols
        while i > 4 and not self.code_length[int(CODELEN_SYM_ORDER[i - 1])]:
            i -= 1
        return i

    def write_raw_table(self, len_bits: int, n_write_symbols: int, writer: BitWriter) -> None:
        if n_write_symbols < 4 or n_write_symbols > self.n_symbols:
            raise ValueError("invalid raw table size")
        for i in range(n_write_symbols):
            writer.put_bits(self.code_length[int(CODELEN_SYM_ORDER[i])], len_bits)


# ---------------------------------------------------------------------------
# CL-table RLE emission. The walk segments the concatenated literal+offset
# code-length array into runs; ``codes_mask`` enables individual RLE codes:
# bit0=code16 (repeat prev), bit1=code17 (short zero run), bit2=code18
# (long zero run), bit3/bit4 toggle the run-of-7/8 4+3 / 4+4
# decompositions off.
# ---------------------------------------------------------------------------


def _walk_var_lengths(code_lengths, n_symbols, codes_mask, on_literal, on_code16, on_code17, on_code18):
    i = 0
    while i < n_symbols:
        run = 1
        while i + run < n_symbols and code_lengths[i + run] == code_lengths[i]:
            run += 1

        if code_lengths[i] == 0:
            if run >= 3:
                while run >= 11 and (codes_mask & 4):
                    chunk = min(run, 138)
                    on_code18(chunk)
                    run -= chunk
                    i += chunk
                while run >= 3 and (codes_mask & 2):
                    chunk = min(run, 10)
                    on_code17(chunk)
                    run -= chunk
                    i += chunk
                if run:
                    run -= 1
                    on_literal(code_lengths[i])
                    i += 1
            else:
                run -= 1
                on_literal(code_lengths[i])
                i += 1
        else:
            run -= 1
            length = min(code_lengths[i], 15)
            on_literal(length)
            i += 1

            if run == 7 and (codes_mask & 1) and not (codes_mask & 8):
                on_code16(4)
                run -= 4
                i += 4
                on_code16(3)
                run -= 3
                i += 3
            elif run == 8 and (codes_mask & 1) and not (codes_mask & 16):
                on_code16(4)
                run -= 4
                i += 4
                on_code16(4)
                run -= 4
                i += 4

            while run >= 3 and (codes_mask & 1):
                chunk = min(run, 6)
                on_code16(chunk)
                run -= chunk
                i += chunk


def write_var_lengths(tables_encoder: HuffmanEncoder, n_symbols: int, code_lengths, codes_mask: int, writer: BitWriter) -> None:
    def lit(length):
        if length > 15:
            raise ValueError("code length exceeds 15")
        tables_encoder.write_codeword(length, writer)

    def code16(chunk):
        tables_encoder.write_codeword(16, writer)
        writer.put_bits(chunk - 3, 2)

    def code17(chunk):
        tables_encoder.write_codeword(17, writer)
        writer.put_bits(chunk - 3, 3)

    def code18(chunk):
        tables_encoder.write_codeword(18, writer)
        writer.put_bits(chunk - 11, 7)

    _walk_var_lengths(code_lengths, n_symbols, codes_mask, lit, code16, code17, code18)
