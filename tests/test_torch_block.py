"""The port's block planner (zultra_tpu_torch.ops.block_torch) against
the JAX package's ``plan_blocks_device_multi`` on the CPU (scan DP,
doubling chain, scan MK), fed the same window stack, match tables and
greedy token marks. Every plan field is compared — is_dynamic, lit_len,
off_len, best_mask, cl_len, n_lit, n_off, total_bits and the packed
words — with exact equality (all integer)."""

import numpy as np
import torch

import jax.numpy as jnp

from zultra_tpu.ops.block_jax import plan_blocks_device_multi as plan_jax
from zultra_tpu_torch import interop
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.ops import block_torch
from zultra_tpu_torch.ops.chain_cuda import chain_marks_plain
from zultra_tpu_torch.ops.matchfinder_torch import HALO, match_tables_device_stacked

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def test_plan_fields_equal_jax():
    mbs = 32768
    rng = np.random.default_rng(31)
    corpus = np.frombuffer(
        mixed_corpus(mbs, seed=32)
        + rng.integers(0, 256, 6000, dtype=np.uint8).tobytes()  # incompressible: static
        + lz_data(mbs - 6000, seed=33, alpha=5, p_match=0.6).tobytes(), np.uint8)
    spans = [(0, mbs), (mbs, 2 * mbs)]
    lens, offs = match_tables_device_stacked(corpus, spans, mbs, "cpu")
    win = np.zeros((2, HALO + mbs), np.uint8)
    win[0, HALO:] = corpus[:mbs]
    win[1] = corpus[: 2 * mbs]
    rl = lens[:, :, 0]
    tok = chain_marks_plain(torch.where(rl >= 3, rl, 1),
                            torch.full((2,), HALO, dtype=torch.int32),
                            torch.full((2,), HALO + mbs, dtype=torch.int32))
    lanes = [(0, HALO, 20000), (0, HALO + 20000, mbs - 20000),
             (1, HALO, 300), (1, HALO + 300, 5700), (1, HALO + 6000, mbs - 6000)]

    got = block_torch.plan_blocks_device_multi(torch.from_numpy(win), lens, offs, lanes, tok)
    host = interop.state_to_numpy({"lens": lens, "offs": offs, "tok": tok})
    want = plan_jax(jnp.asarray(win), jnp.asarray(host["lens"]), jnp.asarray(host["offs"]),
                    lanes, tok_stack=jnp.asarray(host["tok"]))
    assert {p["is_dynamic"] for p in want} == {True, False}  # both block kinds
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for key in w:
            np.testing.assert_array_equal(np.asarray(w[key]), np.asarray(g[key]), err_msg=key)
            assert np.asarray(w[key]).dtype == np.asarray(g[key]).dtype, key
