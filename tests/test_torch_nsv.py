"""The port's NSV queries (ops/nsv_torch.py) on the CPU against the JAX
package's (zultra_tpu/ops/nsv.py) and against direct oracles (a stack for
PSV/NSV, byte comparison for LCPs, a scan for the range queries), over
several seeds. All integers: exact equality."""

import numpy as np
import pytest
import torch

from zultra_tpu.ops.nsv import lcp_pairs_jax, psv_nsv_jax, range_max_below_jax
from zultra_tpu_torch.ops import nsv_torch

torch.set_num_threads(1)  # one thread per pytest worker (test_torch_pipeline.py)


def _stack_psv_nsv(v):
    """Nearest strictly smaller values by a monotone stack."""
    n = len(v)
    psv, nsv = np.full(n, -1, np.int32), np.full(n, n, np.int32)
    stack = []
    for i, x in enumerate(v):
        while stack and v[stack[-1]] >= x:
            stack.pop()
        psv[i] = stack[-1] if stack else -1
        stack.append(i)
    stack = []
    for i in range(n - 1, -1, -1):
        while stack and v[stack[-1]] >= v[i]:
            stack.pop()
        nsv[i] = stack[-1] if stack else n
        stack.append(i)
    return psv, nsv


def _values(seed: int, n: int):
    rng = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:
        return rng.integers(0, 50, n).astype(np.int32)
    if kind == 1:
        return rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    if kind == 2:
        return np.repeat(rng.integers(0, 5, -(-n // 7)), 7)[:n].astype(np.int32)
    return np.arange(n, dtype=np.int32)[:: 1 if seed % 8 == 3 else -1].copy()


@pytest.mark.parametrize("seed, n", [(0, 1), (1, 2), (2, 777), (3, 1000), (4, 2048),
                                     (5, 3001), (6, 4096), (7, 1500)])
def test_psv_nsv_equals_jax_and_stack(seed, n):
    v = _values(seed, n)
    psv, nsv = nsv_torch.psv_nsv(v, device="cpu")
    assert psv.dtype == nsv.dtype == torch.int32
    j_psv, j_nsv = psv_nsv_jax(v)
    s_psv, s_nsv = _stack_psv_nsv(v)
    np.testing.assert_array_equal(psv.numpy(), j_psv)
    np.testing.assert_array_equal(nsv.numpy(), j_nsv)
    np.testing.assert_array_equal(psv.numpy(), s_psv)
    np.testing.assert_array_equal(nsv.numpy(), s_nsv)


def test_psv_nsv_empty_and_tensor_input():
    psv, nsv = nsv_torch.psv_nsv(np.zeros(0, np.int32), device="cpu")
    assert psv.numel() == nsv.numel() == 0
    v = torch.tensor([3, 1, 4, 1, 5, 9, 2, 6], dtype=torch.int64)
    assert [t.tolist() for t in nsv_torch.psv_nsv(v)] == [list(x) for x in _stack_psv_nsv(v.numpy())]


@pytest.mark.parametrize("seed, n, alphabet", [(0, 1, 2), (1, 500, 2), (2, 2000, 4),
                                               (3, 3000, 256), (4, 4096, 1)])
def test_lcp_pairs_equals_jax_and_bytes(seed, n, alphabet):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, alphabet, n).astype(np.uint8)
    i = rng.integers(0, n, 400)
    j = np.where(rng.random(400) < 0.1, i, rng.integers(0, n, 400))
    got = nsv_torch.lcp_pairs(data, i, j, device="cpu")
    np.testing.assert_array_equal(got.numpy(), lcp_pairs_jax(data, i, j))
    for a, b, g in list(zip(i, j, got.tolist()))[:60]:
        m = 0
        while a + m < n and b + m < n and data[a + m] == data[b + m]:
            m += 1
        assert g == m


@pytest.mark.parametrize("seed, n", [(0, 1), (1, 100), (2, 1024), (3, 2500), (4, 4000)])
def test_range_max_below_equals_jax_and_scan(seed, n):
    rng = np.random.default_rng(seed)
    v = _values(seed, n)
    q = 300
    lo = rng.integers(0, n, q)
    hi = np.minimum(n, lo + rng.integers(0, n + 1, q))
    th = rng.choice(np.concatenate([v, v + 1, [np.iinfo(np.int32).min + 1]]), q).astype(np.int32)
    got = nsv_torch.range_max_below(v, lo, hi, th, device="cpu")
    np.testing.assert_array_equal(got.numpy(), range_max_below_jax(v, lo, hi, th))
    for a, b, t, g in zip(lo, hi, th, got.tolist()):
        below = [x for x in v[a:b] if x < t]
        assert g == (max(below) if below else -(1 << 30))
