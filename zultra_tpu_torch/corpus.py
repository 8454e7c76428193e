"""Seeded synthetic corpora for tests and the card smoke run.

``mixed_corpus`` interleaves word-salad text with binary-like records
(little-endian integer tables with small deltas, repeated structs with a
few varying fields), ``text_corpus`` is the word salad alone,
``random_bytes`` is incompressible; all are made from a numpy seed alone
and read no file, so every machine builds the same bytes. ``from_recipe``
builds any of them from a JSON-able [name, size, seed] triple (the form
``smoke_golden.json`` records).
"""

from __future__ import annotations

import functools

import numpy as np

_SYLLABLES = (
    "the of and to in is it that for on with as was by at be this from or "
    "an are not but have they which one all were can there been has more "
    "if will so no what when up out some time into them other than then "
    "data block match window stream offset length table code tree split"
).split()


def _text(rng: np.random.Generator, size: int) -> bytes:
    vocab = [w.encode() for w in _SYLLABLES]
    words = rng.choice(len(vocab), size=size // 3 + 16)
    out = bytearray()
    for i, w in enumerate(words):
        out += vocab[w]
        out += b"\n" if i % 17 == 16 else (b". " if i % 11 == 10 else b" ")
        if len(out) >= size:
            break
    return bytes(out[:size])


def _int_table(rng: np.random.Generator, size: int) -> bytes:
    n = size // 4 + 1
    deltas = rng.integers(-3, 12, n).astype(np.int64)
    vals = (int(rng.integers(0, 1 << 20)) + np.cumsum(deltas)).astype("<u4")
    return vals.tobytes()[:size]


def _structs(rng: np.random.Generator, size: int) -> bytes:
    rec = np.zeros(24, np.uint8)
    rec[:8] = rng.integers(0, 256, 8)
    out = bytearray()
    i = 0
    while len(out) < size:
        r = rec.copy()
        r[8:12] = np.frombuffer(np.uint32(i).tobytes(), np.uint8)
        r[16] = rng.integers(0, 4)
        out += r.tobytes()
        i += 1
    return bytes(out[:size])


def mixed_corpus(size: int, seed: int = 0) -> bytes:
    """``size`` bytes of text interleaved with binary-like records."""
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    makers = (_text, _int_table, _text, _structs)
    k = 0
    while total < size:
        piece = int(rng.integers(2048, 24576))
        parts.append(makers[k % len(makers)](rng, piece))
        total += piece
        k += 1
    return b"".join(parts)[:size]


def lz_data(size: int, seed: int, alpha: int = 256, p_match: float = 0.3) -> np.ndarray:
    """LZ-structured bytes: random literals over ``alpha`` symbols and
    copies of earlier stretches."""
    rng = np.random.default_rng(seed)
    out = np.zeros(size, np.uint8)
    i = 0
    while i < size:
        if i > 10 and rng.random() < p_match:
            off = int(rng.integers(1, min(i, 4000)))
            ln = min(int(rng.integers(3, 120)), size - i)
            for j in range(ln):
                out[i + j] = out[i + j - off]
            i += ln
        else:
            ln = min(int(rng.integers(1, 40)), size - i)
            out[i : i + ln] = rng.integers(0, alpha, ln)
            i += ln
    return out


def text_corpus(size: int, seed: int = 0) -> bytes:
    """``size`` bytes of word salad (the text of ``mixed_corpus``)."""
    return _text(np.random.default_rng(seed), size)


def random_bytes(size: int, seed: int = 0) -> bytes:
    """``size`` uniformly random bytes (incompressible: stored blocks)."""
    return np.random.default_rng(seed).integers(0, 256, size, np.uint8).tobytes()


RECIPES = {"mixed_corpus": mixed_corpus, "text_corpus": text_corpus,
           "random_bytes": random_bytes}


@functools.lru_cache(maxsize=2)
def _build(name: str, size: int, seed: int) -> bytes:
    return RECIPES[name](size, seed)


def from_recipe(recipe) -> bytes:
    """[name, size, seed] -> the corpus ``RECIPES[name](size, seed)``."""
    name, size, seed = recipe
    return _build(name, size, seed)


def case_inputs(case: dict):
    """(data, dictionary or None) of one ``smoke_golden.json`` case: the
    slices ``input`` and ``dictionary`` of its recipe's corpus."""
    corpus = from_recipe(case["recipe"])
    lo, hi = case["input"]
    dic = case["dictionary"]
    return corpus[lo:hi], (corpus[dic[0] : dic[1]] if dic else None)
