"""The port's match stage (zultra_tpu_torch.ops.matchfinder_torch:
segments, prefix-doubling suffix arrays, adjacent LCPs and the plain
walk) against the JAX package's ``match_tables_device_stacked`` on the
CPU (its staircase form, with the host walk on overflowing segments),
for two 32 KiB windows, with and without a preset-dictionary offset.
Lengths and offsets are integers: tolerance is exact equality."""

import numpy as np
import pytest
import torch

from zultra_tpu.ops.matchfinder_jax import match_tables_device_stacked as mt_jax
from zultra_tpu_torch import interop
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import matchfinder_torch as mt
from zultra_tpu_torch.ops.suffix_torch import doubling_rounds

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


@pytest.mark.parametrize("base", [0, 3000])
def test_stacked_tables_two_windows(base):
    mbs = 32768
    corpus = np.frombuffer(
        mixed_corpus(base + 36000, seed=21)
        + np.zeros(2000, np.uint8).tobytes()
        + lz_data(mbs, seed=22, alpha=9).tobytes(), np.uint8)[: base + 2 * mbs - 1000]
    spans = [(base, base + mbs), (base + mbs, len(corpus))]
    lens_j, offs_j = mt_jax(corpus, spans, mbs)
    lens_t, offs_t = mt.match_tables_device_stacked(corpus, spans, mbs, "cpu")
    got = interop.state_to_numpy({"lens": lens_t, "offs": offs_t})
    assert got["lens"].dtype == np.uint16 and got["lens"].shape == (2, mt.HALO + mbs, 8)
    np.testing.assert_array_equal(np.asarray(lens_j), got["lens"])
    np.testing.assert_array_equal(np.asarray(offs_j), got["offs"])
    assert int((got["lens"] > 0).sum()) > 10000


def test_suffix_array_matches_numpy_sort():
    """The doubling rounds give the sorted order of all suffixes."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 3, 700).astype(np.int32)
    buf = np.concatenate([data, 256 + np.arange(60, dtype=np.int32)])
    sa, _, _ = doubling_rounds(torch.from_numpy(buf[None]), store_levels=8)
    want = sorted(range(len(buf)), key=lambda i: buf[i:].tolist())
    assert sa[0].tolist() == want
