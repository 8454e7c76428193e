"""The one traffic generator. A mix is a JSON file ``traffic/<mix>.json``
of parameters; ``make(mix, seed)`` turns it into the run's inputs and the
order in which one closed-loop caller sends them.

A mix has ``inputs`` inputs (1 if not given) of ``size`` bytes each; the
seed draws their content and a shuffled order through them, which
repeats. ``content`` names a maker: ``mixed`` (text interleaved with
integer tables and structs) or ``text``. With ``content_seed``, the
content is drawn from that seed instead, the same in every run, and with
``piece`` and ``group`` as well the run's seed shuffles each input's
whole ``piece``-byte pieces within each run of ``group`` of them (a
shorter last piece stays last): every seed then sends the same pieces,
grouped alike, in another order. The makers are copies of
zultra_tpu_torch/corpus.py's ``mixed_corpus`` and ``_text`` (same bytes
for the same seed; ``_text`` and ``_structs`` vectorized), so that the
inputs stay fixed when the program changes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC = Path(__file__).resolve().parent / "traffic"

_SYLLABLES = (
    "the of and to in is it that for on with as was by at be this from or "
    "an are not but have they which one all were can there been has more "
    "if will so no what when up out some time into them other than then "
    "data block match window stream offset length table code tree split"
).split()
_VOCAB = [w.encode() for w in _SYLLABLES]
_SEPS = (b" ", b". ", b"\n")
# Every (word, separator) token as one flat byte table.
_TOKENS = [w + s for s in _SEPS for w in _VOCAB]
_TOK_LEN = np.array([len(t) for t in _TOKENS], np.int64)
_TOK_START = np.concatenate([[0], np.cumsum(_TOK_LEN)[:-1]])
_TOK_BYTES = np.frombuffer(b"".join(_TOKENS), np.uint8)


def text(rng: np.random.Generator, size: int) -> bytes:
    """Word salad: ``size`` bytes, a newline every 17 words and a full
    stop every 11 (corpus.py ``_text``)."""
    words = rng.choice(len(_VOCAB), size=size // 3 + 16)
    i = np.arange(len(words))
    sep = np.where(i % 17 == 16, 2, np.where(i % 11 == 10, 1, 0))
    tok = sep * len(_VOCAB) + words
    ends = np.cumsum(_TOK_LEN[tok])
    k = int(np.searchsorted(ends, size)) + 1  # tokens until the size is reached
    tok, lens = tok[:k], _TOK_LEN[tok[:k]]
    first = np.repeat(np.cumsum(lens) - lens, lens)
    flat = np.repeat(_TOK_START[tok], lens) + (np.arange(int(lens.sum())) - first)
    return _TOK_BYTES[flat].tobytes()[:size]


def int_table(rng: np.random.Generator, size: int) -> bytes:
    n = size // 4 + 1
    deltas = rng.integers(-3, 12, n).astype(np.int64)
    vals = (int(rng.integers(0, 1 << 20)) + np.cumsum(deltas)).astype("<u4")
    return vals.tobytes()[:size]


def structs(rng: np.random.Generator, size: int) -> bytes:
    """24-byte records: a fixed 8-byte key, a counter, a field of 0-3."""
    n = -(-size // 24)
    recs = np.zeros((n, 24), np.uint8)
    recs[:, :8] = rng.integers(0, 256, 8)
    recs[:, 8:12] = np.arange(n, dtype="<u4").view(np.uint8).reshape(n, 4)
    recs[:, 16] = rng.integers(0, 4, n)
    return recs.tobytes()[:size]


def mixed(size: int, rng: np.random.Generator) -> bytes:
    """Text, integer tables, text and structs in turn, in pieces of
    2-24 KiB (corpus.py ``mixed_corpus``)."""
    parts = []
    total = 0
    makers = (text, int_table, text, structs)
    k = 0
    while total < size:
        piece = int(rng.integers(2048, 24576))
        parts.append(makers[k % len(makers)](rng, piece))
        total += piece
        k += 1
    return b"".join(parts)[:size]


CONTENT = {"mixed": mixed, "text": lambda size, rng: text(rng, size)}


def load(mix: str, root: Path | None = None) -> dict:
    """The parameters of ``mix``, found by its name."""
    return json.loads(((root or TRAFFIC) / f"{mix}.json").read_text())


def make(p: dict, seed: int) -> tuple:
    """(inputs, order): the inputs of one run and the indexes of the
    inputs in the order the caller sends them (cycled)."""
    rng = np.random.default_rng(seed)
    maker = CONTENT[p["content"]]
    source = np.random.default_rng(p["content_seed"]) if "content_seed" in p else rng
    inputs = [maker(int(p["size"]), source) for _ in range(int(p.get("inputs", 1)))]
    if "piece" in p:
        inputs = [shuffle_pieces(x, int(p["piece"]), int(p["group"]), rng) for x in inputs]
    return inputs, [int(i) for i in rng.permutation(len(inputs))]


def shuffle_pieces(data: bytes, piece: int, group: int, rng: np.random.Generator) -> bytes:
    """``data`` with its whole ``piece``-byte pieces shuffled by ``rng``
    within each run of ``group`` of them; the rest stays at the end."""
    whole = len(data) // piece
    order = np.concatenate([lo + rng.permutation(min(group, whole - lo))
                            for lo in range(0, whole, group)] or [np.zeros(0, np.int64)])
    return b"".join(data[i * piece:(i + 1) * piece] for i in order) + data[whole * piece:]
