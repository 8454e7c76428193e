"""The MK and Kraft kernels' schedules, as their plain models
(``mk_cuda.mk_phase12_model``: queue heads in registers, both picks of a
merge step resolved together, phase 2's depths forwarded or read a step
ahead, or pointer jumping for the warp-per-lane layout;
``mk_cuda.kraft_limit_model``: a lane that fits is copied, phase B
divides by a shift), against the plain forms and the JAX package's
Pallas kernels in interpret mode, on numpy-seeded batches whose lanes
are empty, one-symbol, two-symbol, dense (n_used == S), sparse,
power-of-two (codes far past 15 bits) and all-equal (every pick a tie).
The 19-symbol CL alphabet, which the Pallas kernels do not take, goes
through entropy_torch's lengths with the models in place of the
kernels, against entropy_jax's. Inputs no caller gives (unsorted
weights, n_used > S, S = 1 and 2, max_len 1) are held against the plain
forms alone. Each case asserts the counters of the paths its model
took. Every value is an integer: tolerance is exact equality."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zultra_tpu.ops import entropy_jax as ej
from zultra_tpu.ops.mk_pallas import kraft_limit_pallas, mk_phase12_pallas
from zultra_tpu_torch.ops import entropy_torch as et
from zultra_tpu_torch.ops import mk_cuda

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)

B = 24


def _hists(seed, B, S):
    """Lanes cycle through: empty, one symbol, two symbols, dense (every
    symbol used), sparse, powers of two, all weights equal."""
    rng = np.random.default_rng(seed)
    h = np.zeros((B, S), np.int32)
    for b in range(B):
        kind = b % 7
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
        elif kind == 6:
            h[b] = 77
    return h


@functools.lru_cache(maxsize=None)
def _mk_case(S):
    """(sorted weights, n_used, the Pallas kernel's array), computed once
    per S: the interpret-mode runs dominate this file's time."""
    h = _hists(S, B, S)
    a0, n_used, _ = et.mk_inputs(torch.from_numpy(h))
    want = np.asarray(mk_phase12_pallas(jnp.asarray(a0.numpy()), jnp.asarray(n_used.numpy()),
                                        interpret=True))
    return a0, n_used, torch.from_numpy(np.array(want))


@functools.lru_cache(maxsize=None)
def _mk_lengths(S):
    return torch.from_numpy(np.array(ej.mk_lengths(jnp.asarray(_hists(S + 1, B, S)))))


@functools.lru_cache(maxsize=None)
def _kraft_case(S, max_len):
    """(sorted clamped lengths, n_used, kraft0, the Pallas kernel's
    lengths) of entropy_jax's MK lengths of a seeded batch: its complete
    codes within max_len fit, the others need the repair."""
    lens, n_used, kraft0, _, _ = et.kraft_inputs(_mk_lengths(S), max_len)
    want = np.asarray(kraft_limit_pallas(jnp.asarray(lens.numpy()), jnp.asarray(n_used.numpy()),
                                         jnp.asarray(kraft0.numpy()), max_len, interpret=True))
    return lens, n_used, kraft0, torch.from_numpy(np.array(want))


@pytest.mark.parametrize("warp_per_lane", [False, True])
@pytest.mark.parametrize("S", [32, 288])
def test_mk_model_equals_plain_and_pallas(S, warp_per_lane):
    a0, n_used, want = _mk_case(S)
    got, counts = mk_cuda.mk_phase12_model(a0, n_used, warp_per_lane)
    assert torch.equal(got, want)
    assert torch.equal(got, mk_cuda.mk_phase12_plain(a0, n_used))
    # Every kind of joint pick; internal heads forwarded from w and read.
    assert min(counts["pick_ll"], counts["pick_li"], counts["pick_ii"]) > 0, counts
    assert min(counts["head_forwarded"], counts["head_read"]) > 0, counts
    if warp_per_lane:
        assert counts["jump_lanes"] > 0 and counts["serial_lanes"] == 0, counts
        assert counts["jump_rounds"] > 0
    else:
        assert min(counts["depth_forwarded"], counts["depth_read"]) > 0, counts


@pytest.mark.parametrize("max_len", [7, 15])
@pytest.mark.parametrize("S", [32, 288])
def test_kraft_model_equals_plain_and_pallas(S, max_len):
    lens, n_used, kraft0, want = _kraft_case(S, max_len)
    full = 1 << max_len
    assert bool((kraft0 > full).any()) and bool((kraft0 == full).any())
    got, counts = mk_cuda.kraft_limit_model(lens, n_used, kraft0, max_len)
    assert torch.equal(got, want)
    assert torch.equal(got, mk_cuda.kraft_limit_plain(lens, n_used, kraft0, max_len))
    assert counts["fit"] == int((kraft0 == full).sum()) > 0, counts
    assert counts["repaired"] > 0 and counts["lengthened"] > 0, counts


@pytest.mark.parametrize("warp_per_lane", [False, True])
def test_cl_alphabet_models_equal_jax(monkeypatch, warp_per_lane):
    """S = 19: entropy_torch's MK lengths and MK + Kraft lengths at 7 bits
    with both models in place of the kernels equal entropy_jax's."""
    h = _hists(19, 60, 19)
    counts = {}

    def mk_model(a0, n_used):
        out, c = mk_cuda.mk_phase12_model(a0, n_used, warp_per_lane)
        assert torch.equal(out, mk_cuda.mk_phase12_plain(a0, n_used))
        return out

    def kraft_model(lens, n_used, kraft0, max_len):
        out, c = mk_cuda.kraft_limit_model(lens, n_used, kraft0, max_len)
        assert torch.equal(out, mk_cuda.kraft_limit_plain(lens, n_used, kraft0, max_len))
        counts.update(c)
        return out

    monkeypatch.setattr(mk_cuda, "mk_phase12", mk_model)
    monkeypatch.setattr(mk_cuda, "kraft_limit", kraft_model)
    ht = torch.from_numpy(h)
    np.testing.assert_array_equal(et.mk_lengths(ht).numpy(),
                                  np.asarray(ej.mk_lengths(jnp.asarray(h))))
    np.testing.assert_array_equal(et.build_lengths(ht, 7).numpy(),
                                  np.asarray(ej.build_lengths(jnp.asarray(h), 7)))
    assert counts["repaired"] > 0 and counts["shortened"] > 0, counts


@pytest.mark.parametrize("S", [1, 2, 5, 32])
def test_mk_model_on_inputs_no_caller_gives(S):
    """Unsorted weights and n_used from -1 to S + 3, both layouts: equal to
    the plain form (the warp layout falls back to the serial sweep where a
    parent lies at or below its node, possible only for n_used > S)."""
    rng = np.random.default_rng(40 + S)
    a0 = torch.from_numpy(rng.integers(0, 60, (40, S)).astype(np.int32))
    n_used = torch.from_numpy(rng.integers(-1, S + 4, 40).astype(np.int32))
    want = mk_cuda.mk_phase12_plain(a0, n_used)
    for warp_per_lane in (False, True):
        got, _ = mk_cuda.mk_phase12_model(a0, n_used, warp_per_lane)
        assert torch.equal(got, want)


@pytest.mark.parametrize("S,max_len", [(1, 1), (2, 1), (5, 1), (32, 1), (32, 4), (288, 15)])
def test_kraft_model_on_inputs_no_caller_gives(S, max_len):
    """Random lengths 1..max_len in sorted order, n_used from -1 to S + 3,
    Kraft sums over, under and exactly at 2^max_len."""
    rng = np.random.default_rng(50 + S + max_len)
    lens = np.sort(rng.integers(1, max_len + 1, (40, S)), axis=1).astype(np.int32)
    n_used = rng.integers(-1, S + 4, 40).astype(np.int32)
    in_used = np.arange(S)[None, :] < n_used[:, None]
    kraft0 = np.where(in_used, (1 << max_len) >> lens, 0).sum(axis=1).astype(np.int32)
    kraft0[::5] = 1 << max_len
    args = [torch.from_numpy(x) for x in (lens, n_used, kraft0)]
    got, counts = mk_cuda.kraft_limit_model(*args, max_len)
    assert torch.equal(got, mk_cuda.kraft_limit_plain(*args, max_len))
    assert counts["fit"] >= 8 and counts["repaired"] > 0, counts
