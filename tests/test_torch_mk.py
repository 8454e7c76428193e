"""The plain forms of the port's MK and Kraft kernels
(zultra_tpu_torch.ops.mk_cuda) against the JAX package's Pallas kernels
(zultra_tpu.ops.mk_pallas, interpret mode) on numpy-seeded batches with
empty, one-symbol, two-symbol and heavily skewed lanes; the 19-symbol CL
alphabet (which the Pallas kernels do not take) against entropy_jax's
lengths; and the CL-mask search's stacked batch against
entropy_jax.mask_search. Every value is an integer: tolerance is exact
equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu.ops import entropy_jax as ej
from zultra_tpu.ops.mk_pallas import kraft_limit_pallas, mk_phase12_pallas
from zultra_tpu_torch.ops import entropy_torch as et
from zultra_tpu_torch.ops import mk_cuda

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _hists(seed, B, S):
    """Lanes cycle through: empty, one symbol, two symbols, dense,
    sparse, and power-of-two weights (code lengths far past 15)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((B, S), np.int32)
    for b in range(B):
        kind = b % 6
        if kind == 1:
            h[b, rng.integers(S)] = rng.integers(1, 1000)
        elif kind == 2:
            h[b, rng.choice(S, 2, replace=False)] = rng.integers(1, 1000, 2)
        elif kind == 3:
            h[b] = rng.integers(1, 500, S)
        elif kind == 4:
            h[b] = np.where(rng.random(S) < 0.2, rng.integers(1, 1 << 20, S), 0)
        elif kind == 5:
            h[b] = (2 ** rng.integers(0, 21, S)).astype(np.int32)
    return h


def _sorted_weights(h):
    """Used weights sorted by (weight, symbol), zeros after; n_used."""
    key = np.where(h > 0, h, 2**30)
    ks = np.take_along_axis(key, np.argsort(key, axis=1, kind="stable"), axis=1)
    return np.where(ks < 2**30, ks, 0).astype(np.int32), (h > 0).sum(axis=1).astype(np.int32)


def _kraft_inputs(lengths, max_len):
    """Used lengths sorted by (length, symbol) and clamped; n_used;
    the Kraft sum of the clamped lengths."""
    S = lengths.shape[1]
    key = np.where(lengths > 0, lengths * S + np.arange(S), 2**30)
    srt = np.take_along_axis(lengths, np.argsort(key, axis=1, kind="stable"), axis=1)
    clamped = np.minimum(srt, max_len).astype(np.int32)
    n_used = (lengths > 0).sum(axis=1).astype(np.int32)
    in_used = np.arange(S)[None, :] < n_used[:, None]
    kraft0 = np.where(in_used, (1 << max_len) >> clamped, 0).sum(axis=1).astype(np.int32)
    return clamped, n_used, kraft0


@pytest.mark.parametrize("S,B,seed", [(32, 24, 0), (288, 24, 1), (32, 300, 2)])
def test_mk12_plain_equals_pallas(S, B, seed):
    a0, n_used = _sorted_weights(_hists(seed, B, S))
    want = np.asarray(mk_phase12_pallas(jnp.asarray(a0), jnp.asarray(n_used), interpret=True))
    got = mk_cuda.mk_phase12_plain(torch.from_numpy(a0), torch.from_numpy(n_used))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,B,max_len,seed", [(32, 24, 7, 3), (288, 24, 15, 4),
                                              (32, 300, 7, 5)])
def test_kraft_plain_equals_pallas(S, B, max_len, seed):
    lengths = np.asarray(ej.mk_lengths(jnp.asarray(_hists(seed, B, S))))
    clamped, n_used, kraft0 = _kraft_inputs(lengths, max_len)
    assert (kraft0 > (1 << max_len)).any()  # some lanes need the repair
    want = np.asarray(kraft_limit_pallas(jnp.asarray(clamped), jnp.asarray(n_used),
                                         jnp.asarray(kraft0), max_len, interpret=True))
    got = mk_cuda.kraft_limit_plain(torch.from_numpy(clamped), torch.from_numpy(n_used),
                                    torch.from_numpy(kraft0), max_len)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cl_alphabet_lengths_equal_jax():
    """S = 19 (no multiple of 8): MK and MK + Kraft at 7 bits."""
    h = _hists(6, 60, 19)
    ht = torch.from_numpy(h)
    np.testing.assert_array_equal(et.mk_lengths(ht).numpy(), np.asarray(ej.mk_lengths(jnp.asarray(h))))
    np.testing.assert_array_equal(et.build_lengths(ht, 7).numpy(),
                                  np.asarray(ej.build_lengths(jnp.asarray(h), 7)))


def test_mask_search_stacked_batch_equals_jax():
    """The stacked (20 B, 19) histogram batch holds each mask's
    rle_histogram in MASK_ORDER, and the search picks what
    entropy_jax.mask_search picks."""
    lit = np.array(ej.build_lengths(jnp.asarray(_hists(7, 12, 288)), 15))
    off = np.array(ej.build_lengths(jnp.asarray(_hists(8, 12, 32)), 15))
    lt, ot = torch.from_numpy(lit), torch.from_numpy(off)
    hists, _, _ = et.mask_histograms(lt, ot)
    lens, _, _, n_def = et._concat_lengths(lt, ot)
    assert hists.shape == (len(et.MASK_ORDER) * 12, 19)
    for i, mask in enumerate(et.MASK_ORDER):
        want = ej.rle_histogram(jnp.asarray(lens.numpy()), jnp.asarray(n_def.numpy()), mask)
        np.testing.assert_array_equal(hists[i * 12 : (i + 1) * 12].numpy(), np.asarray(want))
    for got, want in zip(et.mask_search(lt, ot), ej.mask_search(jnp.asarray(lit), jnp.asarray(off))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
