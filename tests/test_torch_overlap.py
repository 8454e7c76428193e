"""The one-deep batch pipeline of ``compress_device`` on the CPU (plain
forms of the kernels), at 32 KiB blocks and one window a batch: three
batches, two whole windows and a short tail.

* The schedule: batch 0's match, split and plans, then for each later
  batch its match and split, the splice of every window of the batch
  before it, its plans; the last batch's splice after the loop. The
  stage functions are recorded at the names by which ``device_pipeline``
  calls them.
* The bytes: the JAX package's ``compress_device`` at the same
  ``windows_per_batch`` (one batch after another), in gzip, in zlib with
  a preset dictionary, and where a tiny triggered-candidate budget makes
  every lane take the exact overflow retry, a later batch's after the
  splice of the batch before it.
* The counter ``splice.overlapped``: the batches spliced after the next
  batch's launch, batches - 1 a call, 0 for a one-batch call; two devices
  give the bytes of one.

Tolerance: exact bytes."""

import zlib

import numpy as np
import pytest
import torch

import zultra_tpu.device_pipeline as jax_dp
from zultra_tpu_torch import compress_device, device_pipeline, profiling
from zultra_tpu_torch.corpus import mixed_corpus

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

BLOCK = 32768
DATA = mixed_corpus(2 * BLOCK + 3000, seed=301)  # three windows: three batches of one
DICTIONARY = mixed_corpus(2000, seed=302)
BATCHES = [1, 1, 1]  # windows a batch


def _decode(out, flags, dictionary=None):
    wbits = {0: -15, 1: 15, 2: 31}[flags]
    d = zlib.decompressobj(wbits, zdict=dictionary) if dictionary else zlib.decompressobj(wbits)
    return d.decompress(out) + d.flush()


def _recorded(flags, dictionary=None, trig_cap=None, **kwargs):
    """(output, stage calls in order, tracer report) of a compression with
    the tracer on; a split call is recorded with its triggered-candidate
    budget (0 for the exact retry), a match call with its batch's first
    span."""
    calls = []

    def recorder(name, fn):
        def wrapper(*args, **kw):
            if name == "match":
                calls.append(("match", args[1][0][0]))
            elif name == "split":
                calls.append(("split", args[6]))
            else:
                calls.append((name,))
            return fn(*args, **kw)

        return wrapper

    profiling.reset()
    profiling.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name, attr in (("match", "match_stacks"), ("split", "split_batch"),
                               ("plan", "plan_blocks_device_multi"),
                               ("emit", "emit_window_from_plan")):
                mp.setattr(device_pipeline, attr, recorder(name, getattr(device_pipeline, attr)))
            if trig_cap is not None:
                mp.setattr(device_pipeline, "trig_cap_for", lambda cap: trig_cap)
            out = compress_device(DATA, flags, BLOCK, dictionary, windows_per_batch=1,
                                  device="cpu", **kwargs)
    finally:
        profiling.enable(False)
    return out, calls, profiling.report(reset=True)


def _schedule(batches, cap, retried=(), base=0):
    """The stage calls of the one-deep pipeline over batches of the given
    window counts, each split at budget ``cap``, the batches in
    ``retried`` with the exact retry in their finish; the input starts at
    ``base`` in the corpus (after a dictionary)."""
    starts = base + np.cumsum([0] + batches[:-1]) * BLOCK

    def launch(g):
        return [("match", int(starts[g])), ("split", cap)]

    def finish(g):
        return ([("split", 0)] if g in retried else []) + [("plan",)]

    order = launch(0) + finish(0)
    for g in range(1, len(batches)):
        order += launch(g) + [("emit",)] * batches[g - 1] + finish(g)
    return order + [("emit",)] * batches[-1]


@pytest.fixture(scope="module")
def jax_gzip():
    return jax_dp.compress_device(DATA, 2, BLOCK, windows_per_batch=1)


@pytest.fixture(scope="module")
def gzip_run():
    return _recorded(2)


def test_gzip_schedule_and_bytes(gzip_run, jax_gzip):
    out, calls, _ = gzip_run
    assert calls == _schedule(BATCHES, device_pipeline.trig_cap_for(BLOCK))
    assert out == jax_gzip
    assert _decode(out, 2) == DATA


def test_zlib_dictionary_schedule_and_bytes():
    out, calls, _ = _recorded(1, DICTIONARY)
    assert calls == _schedule(BATCHES, device_pipeline.trig_cap_for(BLOCK), base=len(DICTIONARY))
    assert out == jax_dp.compress_device(DATA, 1, BLOCK, DICTIONARY, windows_per_batch=1)
    assert _decode(out, 1, DICTIONARY) == DATA


def test_overflow_retry_of_a_later_batch_after_the_splice(jax_gzip):
    """A budget of one triggered candidate a level: both whole windows
    overflow and rerun exactly, batch 1's rerun in its finish, after
    batch 0's splice; the short tail does not overflow."""
    out, calls, report = _recorded(2, trig_cap=1)
    assert calls == _schedule(BATCHES, 1, retried=(0, 1))
    assert report["counters"]["split.retry"] == 2
    assert out == jax_gzip


def test_splice_overlapped_counts_batches_but_one(gzip_run):
    _, _, report = gzip_run
    assert report["counters"]["splice.overlapped"] == len(BATCHES) - 1
    assert report["spans"]["zultra.splice"]["calls"] == sum(BATCHES)
    assert report["spans"]["zultra.checksum"]["calls"] == 1


def test_one_batch_call_overlaps_nothing():
    data = mixed_corpus(3000, seed=303)
    profiling.enable()
    try:
        out = compress_device(data, 2, BLOCK, device="cpu")
    finally:
        profiling.enable(False)
    counters = profiling.report(reset=True)["counters"]
    assert counters["splice.overlapped"] == 0
    assert _decode(out, 2) == data


def test_two_devices_give_the_bytes_of_one(gzip_run):
    """Two CPU devices, one window each a batch: two batches, the first
    spliced after the second's launch."""
    out, calls, report = _recorded(2, devices=["cpu", "cpu"])
    assert out == gzip_run[0]
    assert report["counters"]["splice.overlapped"] == 1
    assert calls.index(("emit",)) > max(i for i, c in enumerate(calls) if c[0] == "match")
