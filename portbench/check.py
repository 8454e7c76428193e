"""What decides ``correct``: the outputs of the timed calls, held against
their inputs and against the plain reference encoder
(``portbench.reference``), which shares no code with the program.

Three numbers, each exact (limit 0):

- ``unequal_calls``: calls whose output differs from the first output
  of the same input in the window (every call is compared).
- ``roundtrip_bad``: inputs whose first output is not a whole gzip
  stream (header, CRC-32 and size trailer, nothing after it) that
  inflates to the input. The inflater is zlib's, which is not the
  program's.
- ``ref_mismatch``: windows, drawn from the seed among those of the
  inputs sent, one from each of as many equal runs of them (in input and
  window order) as are drawn, whose bits the reference writes and which
  do not lie in the program's stream where they belong: window 0 right
  after the header, a later window anywhere after it at any bit phase,
  its partial first and last bytes compared bit by bit. Files of at most
  one window each are so compared whole.

The reference's windows are planned in a pool of processes: one task a
window (match table and split points), then, as soon as a window's plan
is there, one task a block.
"""

from __future__ import annotations

import multiprocessing
import os
import zlib
from concurrent.futures import ProcessPoolExecutor, as_completed

import numpy as np

from .reference import blocks, encode

LIMITS = {"unequal_calls": 0, "roundtrip_bad": 0, "ref_mismatch": 0}
HEADER = 10  # bytes of the gzip header zultra writes


def roundtrip_ok(out: bytes, data: bytes) -> bool:
    d = zlib.decompressobj(31)
    try:
        got = d.decompress(out) + d.flush()
    except zlib.error:
        return False
    return d.eof and not d.unused_data and got == data


def sample_windows(inputs: list, sent: list, mbs: int, n: int, seed: int) -> list:
    """``n`` (input, window) pairs drawn from the seed among the windows of
    the inputs that the window sent: the windows, in input and window
    order, cut into ``n`` runs of equal length (to one), and one drawn
    from each, so that a sample reaches both ends of a long input."""
    pairs = [(i, k) for i in sorted(set(sent))
             for k in range(len(encode.window_spans(len(inputs[i]), mbs)))]
    rng = np.random.default_rng([seed, 1])
    runs = np.array_split(np.arange(len(pairs)), min(n, len(pairs)))
    return [pairs[int(rng.choice(r))] for r in runs]


def _set_passes(passes: int) -> None:
    blocks.CONVERGENCE_PASSES = passes


def reference_windows(inputs: list, pairs: list, mbs: int, workers: int,
                      passes: int = blocks.CONVERGENCE_PASSES) -> list:
    """(window, prev, ends, blocks, is_last) of each sampled window,
    planned by the reference in ``workers`` processes, whose dynamic blocks
    run ``passes`` + 1 parse passes."""
    ctx = multiprocessing.get_context("spawn")
    spans = [encode.window_spans(len(inputs[i]), mbs) for i, _ in pairs]
    windows = [encode.window_of(inputs[i], *s[k]) for (i, k), s in zip(pairs, spans)]
    with ProcessPoolExecutor(max(1, workers), mp_context=ctx, initializer=_set_passes,
                             initargs=(passes,)) as pool:
        planned = {pool.submit(encode.window_plan, *windows[w]): w for w in range(len(pairs))}
        plans, futures = {}, {}
        for done in as_completed(planned):  # a window's blocks, the largest first
            w = planned[done]
            table, ends = plans[w] = done.result()
            spans_w = zip([windows[w][1]] + list(ends[:-1]), ends)
            for j, (b, e) in sorted(enumerate(spans_w), key=lambda t: t[1][0] - t[1][1]):
                futures[w, j] = pool.submit(encode.block_bits, windows[w][0], table[b:e], b, e)
        out = []
        for w, (window, prev) in enumerate(windows):
            ends = plans[w][1]
            bits = [futures[w, j].result() for j in range(len(ends))]
            out.append((window, prev, ends, bits, pairs[w][1] == len(spans[w]) - 1))
    return out


def window_found(stream: bytes, k: int, ref: tuple) -> bool:
    """Whether the reference's window ``k`` lies in ``stream``."""
    window, prev, ends, planned, is_last = ref
    for phase in ([0] if k == 0 else range(8)):
        bits, end = encode.splice_window(window, prev, ends, planned, phase, is_last)
        at = encode.find_window(stream, bits, end, phase, HEADER - 1 if k == 0 else HEADER)
        if (at == HEADER) if k == 0 else (at > HEADER):
            return True
    return False


def compare(inputs: list, sent: list, outputs: list, mbs: int, seed: int,
            ref_windows: int, workers: int = 0) -> dict:
    """The three numbers of the module's docstring for the calls that sent
    ``inputs[sent[j]]`` and returned ``outputs[j]`` (None for a call that
    raised)."""
    first = {}
    unequal = 0
    for i, out in zip(sent, outputs):
        if out is None:
            continue
        if i not in first:
            first[i] = out
        elif out != first[i]:
            unequal += 1
    bad = sum(not roundtrip_ok(first[i], inputs[i]) if i in first else 1 for i in set(sent))
    pairs = sample_windows(inputs, sent, mbs, ref_windows, seed)
    refs = reference_windows(inputs, pairs, mbs, workers or min(8, os.cpu_count() or 1))
    mismatch = sum(not (i in first and window_found(first[i], k, ref))
                   for (i, k), ref in zip(pairs, refs))
    return {"unequal_calls": unequal, "roundtrip_bad": bad, "ref_mismatch": mismatch}
