"""The port's block splitter (zultra_tpu_torch.ops.split_torch) against
the JAX package's ``_split_kernel_batch`` on the CPU, fed the SAME match
tables: the JAX stage's uint16 tables cross over through
``zultra_tpu_torch.interop``, so the splitter is held apart from the
match stage. Split points, split counts, overflow flags and greedy
token marks are integers: tolerance is exact equality."""

import numpy as np
import torch

import jax.numpy as jnp

from zultra_tpu.ops.matchfinder_jax import HALO, match_tables_device_stacked
from zultra_tpu.ops.split_jax import _split_kernel_batch
from zultra_tpu_torch import interop
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import split_torch as st

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def test_split_points_from_jax_match_tables():
    mbs = 65536
    corpus = np.frombuffer(
        mixed_corpus(70000, seed=11) + lz_data(50000, seed=12, alpha=12).tobytes(), np.uint8)
    spans = [(0, mbs), (mbs, len(corpus))]
    lens, offs = match_tables_device_stacked(corpus, spans, mbs)
    W, n_lane = len(spans), HALO + mbs
    win = np.zeros((W, n_lane), np.uint8)
    for w, (lo, hi) in enumerate(spans):
        prev = min(HALO, lo)
        win[w, HALO - prev : HALO + hi - lo] = corpus[lo - prev : hi]
    n_pad = st.split_bucket(n_lane)
    state = {"win": np.pad(win, ((0, 0), (0, n_pad - n_lane))),
             "lens": np.asarray(lens), "offs": np.asarray(offs)}
    n_real = np.array([HALO + hi - lo for lo, hi in spans], np.int32)
    in_cap = st.input_cap(mbs)

    rl = np.pad(state["lens"][:, :, 0].astype(np.int32), ((0, 0), (0, n_pad - n_lane)))
    ro = np.pad(state["offs"][:, :, 0].astype(np.int32), ((0, 0), (0, n_pad - n_lane)))
    t = interop.state_from_numpy({"win": state["win"], "lens": state["lens"],
                                  "offs": state["offs"], "n_real": n_real}, "cpu")
    rl_t = torch.nn.functional.pad(t["lens"][:, :, 0], (0, n_pad - n_lane))
    ro_t = torch.nn.functional.pad(t["offs"][:, :, 0], (0, n_pad - n_lane))
    assert np.array_equal(rl_t.numpy(), rl)

    for trig_cap in (st.trig_cap_for(in_cap), 0, 1):
        want = _split_kernel_batch(
            jnp.asarray(state["win"]), jnp.asarray(rl), jnp.asarray(ro), jnp.int32(HALO),
            jnp.asarray(n_real), n_pad, in_cap, trig_cap=trig_cap)
        got = st.split_batch(t["win"], rl_t, ro_t, HALO, t["n_real"], in_cap, trig_cap)
        for name, a, b in zip(("splits", "n_splits", "tok_marks", "ovf"), want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
        if trig_cap == 0:
            assert int(np.asarray(want[1]).sum()) > 0  # the case exercises real splits
