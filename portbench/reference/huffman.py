"""Copy of zultra_tpu/huffman.py (the JAX package's NumPy-only reference
semantics), part of the benchmark's plain reference encoder. It imports
only numpy, the standard library and its sibling copies.

Huffman entropy-coding layer.

TPU-native reimplementation of the reference entropy layer
(src/huffman/huffencoder.c, src/huffman/huffutils.c) with identical
decisions and tie-breaking, so that canonical code assignments — and hence
the emitted bitstream — are byte-for-byte identical:

* Moffat–Katajainen in-place code-length construction
  (huffencoder.c:157-270), operating on symbols sorted by
  (frequency, symbol index) ascending.
* Kraft-sum length limiting with backward error propagation
  (huffencoder.c:279-346).
* Canonical codeword issue in (length, symbol index) order with bit-reversed
  codewords (huffencoder.c:348-372).
* Code-length (CL) alphabet RLE encode/cost/emit trio with the per-mask
  enable bits and the run-of-7/8 special cases (huffencoder.c:446-735).
* Zopfli-style histogram rewriting for better RLE compressibility
  (huffutils.c:34-114).

The alphabets are tiny (≤288 symbols), so this layer runs on the host; the
per-block symbol histograms it consumes are produced by the vectorized /
TPU paths.
"""

from __future__ import annotations

from .bitwriter import BitWriter
from .constants import CODELEN_SYM_ORDER, MAX_SYMBOLS, NCODELENSYMS


def _sorted_by_value_then_index(values, indices):
    """Ascending by (values[idx], idx) — the total order produced by the
    reference's index qsort (huffencoder.c:34-61)."""
    return sorted(indices, key=lambda idx: (values[idx], idx))


def moffat_katajainen_code_lengths(sorted_freqs):
    """In-place minimum-redundancy code length computation.

    ``sorted_freqs``: list of frequencies sorted ascending (ties broken by
    symbol index upstream). Returns the list of code lengths, positionally
    matching the sorted input. Implements the two-phase in-place algorithm
    of Moffat & Katajainen as used by the reference (huffencoder.c:183-255).
    """
    a = list(sorted_freqs)
    n = len(a)
    if n == 0:
        return []
    if n == 1:
        return [1]

    # Phase 1: build internal node weights in place; a[t] becomes the weight
    # of internal node t, then later the index (1-based) of its parent.
    s = 0  # next unused leaf
    r = 0  # next unused internal node
    for t in range(n - 1):
        if s >= n or (r < t and a[r] < a[s]):
            new_weight = a[r]
            a[r] = t + 1
            r += 1
        else:
            new_weight = a[s]
            s += 1
        if s >= n or (r < t and a[r] < a[s]):
            new_weight += a[r]
            a[r] = t + 1
            r += 1
        else:
            new_weight += a[s]
            s += 1
        a[t] = new_weight

    # Phase 2: convert parent pointers to depths, then expand to leaf counts.
    a[n - 2] = 0
    for t in range(n - 3, -1, -1):
        a[t] = a[a[t] - 1] + 1

    avail = 1
    used = 0
    depth = 0
    next_leaf = n - 1
    t = n - 2
    while avail > 0:
        while t >= 0 and a[t] == depth:
            used += 1
            t -= 1
        while avail > used:
            a[next_leaf] = depth
            next_leaf -= 1
            avail -= 1
        avail = used << 1
        depth += 1
        used = 0

    return a


def _reverse_bits16(word: int, nbits: int) -> int:
    w = ((word & 0x5555) << 1) | ((word & 0xAAAA) >> 1)
    w = ((w & 0x3333) << 2) | ((w & 0xCCCC) >> 2)
    w = ((w & 0x0F0F) << 4) | ((w & 0xF0F0) >> 4)
    w = ((w & 0x00FF) << 8) | ((w & 0xFF00) >> 8)
    return w >> (16 - nbits)


class HuffmanEncoder:
    """One Huffman alphabet: histogram, code lengths, canonical codewords."""

    __slots__ = ("n_symbols", "max_code_length", "entropy", "code_word", "code_length")

    def __init__(self, n_symbols: int, max_code_length: int, default_code_length: int = 0):
        if not (0 <= n_symbols <= MAX_SYMBOLS) or not (0 <= max_code_length <= 32):
            raise ValueError("invalid huffman encoder parameters")
        self.n_symbols = n_symbols
        self.max_code_length = max_code_length
        self.entropy = [0] * MAX_SYMBOLS
        self.code_word = [0] * MAX_SYMBOLS
        self.code_length = [default_code_length] * n_symbols + [0] * (MAX_SYMBOLS - n_symbols)

    def copy(self) -> "HuffmanEncoder":
        clone = HuffmanEncoder.__new__(HuffmanEncoder)
        clone.n_symbols = self.n_symbols
        clone.max_code_length = self.max_code_length
        clone.entropy = list(self.entropy)
        clone.code_word = list(self.code_word)
        clone.code_length = list(self.code_length)
        return clone

    # -- code length construction -----------------------------------------

    def estimate_dynamic_codelens(self) -> None:
        """Compute unlimited minimum-redundancy code lengths from the
        histogram (huffencoder.c:157-270). Does NOT length-limit."""
        used = [i for i in range(self.n_symbols) if self.entropy[i]]
        if len(used) > 1:
            order = _sorted_by_value_then_index(self.entropy, used)
            lengths = moffat_katajainen_code_lengths([self.entropy[i] for i in order])
            self.code_length = [0] * MAX_SYMBOLS
            for pos, sym in enumerate(order):
                self.code_length[sym] = lengths[pos]
        else:
            # Zero or one used symbols: single 1-bit code assigned to symbol
            # 0 regardless of which symbol was used (reference quirk,
            # huffencoder.c:263-267).
            self.code_length = [0] * MAX_SYMBOLS
            self.code_length[0] = 1

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

    def build_dynamic_codewords(self) -> None:
        """Code lengths from histogram, Kraft length limiting, canonical
        codewords (huffencoder.c:279-375)."""
        self.estimate_dynamic_codelens()

        used = [i for i in range(self.n_symbols) if self.code_length[i]]
        if used and self.max_code_length > 0:
            order = _sorted_by_value_then_index(self.code_length, used)
            max_len = self.max_code_length
            if self.code_length[order[-1]] > max_len:
                # Clamp all overlong codes, then fix the Kraft sum by
                # lengthening the rarest symbols (end of the sorted order)
                # and finally re-shortening the most frequent ones when the
                # sum leaves room.
                kraft = 0
                full = 1 << max_len
                for sym in reversed(order):
                    if self.code_length[sym] > max_len:
                        self.code_length[sym] = max_len
                    kraft += full >> self.code_length[sym]

                for sym in reversed(order):
                    if kraft <= full:
                        break
                    while self.code_length[sym] < max_len and kraft > full:
                        self.code_length[sym] += 1
                        kraft -= full >> self.code_length[sym]

                for sym in order:
                    if kraft >= full:
                        break
                    while kraft + (full >> self.code_length[sym]) <= full:
                        kraft += full >> self.code_length[sym]
                        self.code_length[sym] -= 1

                order = _sorted_by_value_then_index(self.code_length, used)
            self._issue_canonical(order)
        elif used:
            self._issue_canonical(_sorted_by_value_then_index(self.code_length, used))

    # -- emission ----------------------------------------------------------

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

    def get_defined_var_lengths_count(self, min_symbols: int) -> int:
        i = self.n_symbols
        while i > min_symbols and not self.code_length[i - 1]:
            i -= 1
        return i


# ---------------------------------------------------------------------------
# CL-table RLE trio. Each walks the concatenated literal+offset code-length
# array with identical run segmentation; they differ only in what they do per
# emitted CL symbol (count it / cost it / write it). The ``codes_mask``
# enables individual RLE codes: bit0=code16 (repeat prev), bit1=code17
# (short zero run), bit2=code18 (long zero run), bit3/bit4 toggle the
# run-of-7/8 4+3 / 4+4 decompositions off.
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


def update_var_lengths_entropy(tables_encoder: HuffmanEncoder, n_symbols: int, code_lengths, codes_mask: int) -> None:
    ent = tables_encoder.entropy

    def lit(length):
        ent[length] += 1

    _walk_var_lengths(
        code_lengths, n_symbols, codes_mask,
        on_literal=lit,
        on_code16=lambda chunk: ent.__setitem__(16, ent[16] + 1),
        on_code17=lambda chunk: ent.__setitem__(17, ent[17] + 1),
        on_code18=lambda chunk: ent.__setitem__(18, ent[18] + 1),
    )


def get_var_lengths_size(tables_encoder: HuffmanEncoder, n_symbols: int, code_lengths, codes_mask: int) -> int:
    cl = tables_encoder.code_length
    total = 0

    def lit(length):
        nonlocal total
        total += cl[length]

    def code16(chunk):
        nonlocal total
        total += cl[16] + 2

    def code17(chunk):
        nonlocal total
        total += cl[17] + 3

    def code18(chunk):
        nonlocal total
        total += cl[18] + 7

    _walk_var_lengths(code_lengths, n_symbols, codes_mask, lit, code16, code17, code18)
    return total


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


# ---------------------------------------------------------------------------
# Zopfli-style histogram rewriting (huffutils.c:34-114, Apache-2.0 heritage;
# reimplemented from the published algorithm).
# ---------------------------------------------------------------------------


def optimize_histogram_for_rle(length: int, counts) -> None:
    """Rewrite population counts in place so the resulting code lengths
    RLE-compress better. ``counts`` is a mutable sequence of ≥ ``length``
    non-negative ints."""
    # 1) Never touch trailing zeros (would add invalid symbols).
    while length >= 0:
        if length == 0:
            return
        if counts[length - 1] != 0:
            break
        length -= 1

    # 2) Mark runs that are already good for RLE (zero runs ≥ 5,
    #    non-zero runs ≥ 7) so they are left alone.
    good_for_rle = [False] * length
    symbol = counts[0]
    stride = 0
    for i in range(length + 1):
        if i == length or counts[i] != symbol:
            if (symbol == 0 and stride >= 5) or (symbol != 0 and stride >= 7):
                for k in range(stride):
                    good_for_rle[i - k - 1] = True
            stride = 1
            if i != length:
                symbol = counts[i]
        else:
            stride += 1

    # 3) Collapse strides of similar counts to their rounded average.
    stride = 0
    limit = counts[0]
    total = 0
    for i in range(length + 1):
        if i == length or good_for_rle[i] or abs(counts[i] - limit) >= 4:
            if stride >= 4 or (stride >= 3 and total == 0):
                count = (total + stride // 2) // stride
                if count < 1:
                    count = 1
                if total == 0:
                    count = 0
                for k in range(stride):
                    counts[i - k - 1] = count
            stride = 0
            total = 0
            if i < length - 3:
                limit = (counts[i] + counts[i + 1] + counts[i + 2] + counts[i + 3] + 2) // 4
            elif i < length:
                limit = counts[i]
            else:
                limit = 0
        stride += 1
        if i != length:
            total += counts[i]


def make_tables_encoder() -> HuffmanEncoder:
    return HuffmanEncoder(NCODELENSYMS, 7, 0)
