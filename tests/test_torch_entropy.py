"""The port's Huffman bundle (zultra_tpu_torch.ops.entropy_torch) against
the JAX package's scan forms (zultra_tpu.ops.entropy_jax with
ZULTRA_MK_IMPL unset on the CPU, i.e. the scans) on numpy-seeded
histogram batches. Every output is integer: tolerance is exact
equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu.ops import entropy_jax as ej
from zultra_tpu_torch.ops import entropy_torch as et

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _hists(seed, B, S, skew):
    """Histograms with a mix of empty, single-symbol, sparse and heavy
    -tailed lanes (the last force Kraft repairs past 15 bits)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((B, S), np.int32)
    for b in range(B):
        kind = b % 5
        if kind == 0:
            continue
        if kind == 1:
            h[b, rng.integers(S)] = rng.integers(1, 100)
            continue
        used = rng.random(S) < (0.15 if kind == 2 else 0.9)
        if kind == 4:
            w = (2.0 ** rng.integers(0, skew, S)).astype(np.int64)
        else:
            w = rng.integers(1, 500, S)
        h[b] = np.where(used, w, 0).astype(np.int32)
    return h


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


@pytest.mark.parametrize("S,seed", [(288, 0), (32, 1), (19, 2)])
def test_lengths_and_codewords(S, seed):
    h = _hists(seed, 20, S, 24)
    ht = torch.from_numpy(h)
    _eq(ej.mk_lengths(jnp.asarray(h)), et.mk_lengths(ht))
    for max_len in (15, 7):
        lj = ej.build_lengths(jnp.asarray(h), max_len)
        lt = et.build_lengths(ht, max_len)
        _eq(lj, lt)
        _eq(ej.canonical_codewords(lj), et.canonical_codewords(lt))


def test_rle_rewrite_and_costs():
    h = _hists(3, 20, 288, 18)
    o = _hists(4, 20, 32, 18)
    hj, oj = jnp.asarray(h), jnp.asarray(o)
    ht, ot = torch.from_numpy(h), torch.from_numpy(o)
    _eq(ej.optimize_for_rle_jax(hj), et.optimize_for_rle(ht))
    _eq(ej.optimize_for_rle_jax(oj), et.optimize_for_rle(ot))
    _eq(ej.static_cost(hj, oj), et.static_cost(ht, ot))
    _eq(ej.dynamic_cost(hj, oj), et.dynamic_cost(ht, ot))
    ll, ol = ej.build_lengths(hj, 15), ej.build_lengths(oj, 15)
    llt, olt = torch.from_numpy(np.asarray(ll)), torch.from_numpy(np.asarray(ol))
    _eq(ej.dynamic_cost_given(hj, oj, ll, ol), et.dynamic_cost_given(ht, ot, llt, olt))
    for got, want in zip(et.mask_search(llt, olt), ej.mask_search(ll, ol)):
        _eq(want, got)


def test_rle_statistics_per_mask():
    rng = np.random.default_rng(5)
    lens = rng.choice([0, 0, 0, 3, 5, 8, 8, 8, 17], size=(12, 320)).astype(np.int32)
    n_def = rng.integers(1, 321, 12).astype(np.int32)
    te = rng.integers(0, 8, (12, 19)).astype(np.int32)
    lt, nt, tt = map(torch.from_numpy, (lens, n_def, te))
    for mask in (0, 1, 7, 8, 16, 31):
        _eq(ej.rle_histogram(jnp.asarray(lens), jnp.asarray(n_def), mask),
            et.rle_histogram(lt, nt, mask))
        _eq(ej.rle_bits(jnp.asarray(lens), jnp.asarray(n_def), jnp.asarray(te), mask),
            et.rle_bits(lt, nt, tt, mask))
    _eq(ej.raw_table_size(jnp.asarray(te)), et.raw_table_size(tt))
    _eq(ej.defined_count(jnp.asarray(lens), 257), et.defined_count(lt, 257))
