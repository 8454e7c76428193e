"""Moffat-Katajainen phases 1-2 and Kraft-sum length limiting (kernels
``csrc/mk.cu``) and their plain PyTorch versions.

Same contracts as zultra_tpu.ops.mk_pallas.mk_phase12_pallas and
kraft_limit_pallas (reference src/huffman/huffencoder.c:157-270 and
:279-346). Every histogram of a batch is a lane; the plain versions are
loops over the (at most 288-entry) symbol axis with the lanes as
vectors. The kernels take any S up to 288: the JAX package's
``S % 8 == 0`` guard is a TPU tiling limit, not semantics.
"""

from __future__ import annotations

import torch

from .. import _build
from .symbol_map import floor_log2

MAX_S = 288  # the kernels' shared-memory array holds 288 symbols per lane
I32 = torch.int32
I64 = torch.int64

mk12_launches = 0  # kernel launches since the last reset
kraft_launches = 0


def _check(name: str, rows: torch.Tensor, *lanes: torch.Tensor) -> None:
    _build.check_cuda(name, rows, I32, 2)
    for t in lanes:
        _build.check_cuda(name, t, I32, 1)
        if t.shape[0] != rows.shape[0]:
            raise ValueError(f"{name}: expected one entry per lane")
    if not 1 <= rows.shape[1] <= MAX_S:
        raise ValueError(f"{name}: {rows.shape[1]} symbols, the kernel takes 1..{MAX_S}")


def mk_phase12(a0: torch.Tensor, n_used: torch.Tensor) -> torch.Tensor:
    """a0 (B, S) int32 weights sorted ascending (slots past n_used
    arbitrary), n_used (B,) int32 -> (B, S) int32: the in-place array
    after the two-queue merge and the parent-chain depths (internal
    node depths at t < n_used - 1)."""
    global mk12_launches
    if a0.device.type == "cpu":
        return mk_phase12_plain(a0, n_used)
    _check("mk12", a0, n_used)
    B, S = a0.shape
    out = torch.empty_like(a0)
    _build.launch("zt_mk12", a0.data_ptr(), n_used.data_ptr(), out.data_ptr(), B, S)
    mk12_launches += 1
    return out


def mk_phase12_plain(a0: torch.Tensor, n_used: torch.Tensor) -> torch.Tensor:
    B, S = a0.shape
    dev = a0.device
    rows = torch.arange(B, dtype=I64, device=dev)
    # Column S is a dump slot for the writes of lanes that take no
    # internal node (the JAX scan drops them).
    a_ext = torch.zeros((B, S + 1), dtype=I32, device=dev)
    a_ext[:, :S] = a0
    a = a_ext[:, :S]

    # Phase 1: two-queue merge over t = 0..S-2.
    leaf = torch.zeros(B, dtype=I64, device=dev)
    internal = torch.zeros(B, dtype=I64, device=dev)
    n_used64 = n_used.to(I64)

    def pick(t, w_acc, active):
        nonlocal leaf, internal
        av_leaf = a[rows, torch.clamp(leaf, 0, S - 1)]
        av_int = a[rows, torch.clamp(internal, 0, S - 1)]
        take_int = ((leaf >= n_used64) | ((internal < t) & (av_int < av_leaf))) & active
        w_acc = w_acc + torch.where(take_int, av_int, av_leaf)
        a_ext.scatter_(1, torch.where(take_int, internal, S)[:, None], t + 1)
        internal = internal + take_int.to(I64)
        leaf = leaf + (active & ~take_int).to(I64)
        return w_acc

    for t in range(S - 1):
        active = t < n_used64 - 1
        w = pick(t, torch.zeros(B, dtype=I32, device=dev), active)
        w = pick(t, w, active)
        a[:, t] = torch.where(active, w, a[:, t])

    # Phase 2: internal depths via the parent chain (parents sit at
    # larger indices, so a backward sweep resolves each in one step).
    root = torch.clamp(n_used64 - 2, 0, S - 1)
    a[rows, root] = 0
    for t in range(S - 3, -1, -1):
        active = t <= n_used64 - 3
        parent = a[:, t].to(I64) - 1
        pdepth = a[rows, torch.clamp(parent, 0, S - 1)]
        a[:, t] = torch.where(active, pdepth + 1, a[:, t])
    return a.contiguous()


def kraft_limit(clamped_sorted: torch.Tensor, n_used: torch.Tensor, kraft0: torch.Tensor,
                max_len: int) -> torch.Tensor:
    """clamped_sorted (B, S) int32 lengths already min(., max_len) and
    sorted by (length, symbol) (slots past n_used arbitrary), n_used and
    kraft0 (B,) int32 (kraft0 the Kraft sum of the clamped lengths),
    max_len 1..15 -> (B, S) int32 repaired sorted lengths: lengthen from
    position S-1 down while the sum is over 2^max_len, then shorten from
    position 0 up while room remains."""
    global kraft_launches
    if clamped_sorted.device.type == "cpu":
        return kraft_limit_plain(clamped_sorted, n_used, kraft0, max_len)
    _check("kraft", clamped_sorted, n_used, kraft0)
    if not 1 <= max_len <= 15:
        raise ValueError(f"kraft: max_len {max_len} outside 1..15")
    B, S = clamped_sorted.shape
    out = torch.empty_like(clamped_sorted)
    _build.launch("zt_kraft", clamped_sorted.data_ptr(), n_used.data_ptr(), kraft0.data_ptr(),
                  out.data_ptr(), B, S, max_len)
    kraft_launches += 1
    return out


def kraft_limit_plain(clamped_sorted: torch.Tensor, n_used: torch.Tensor, kraft0: torch.Tensor,
                      max_len: int) -> torch.Tensor:
    B, S = clamped_sorted.shape
    full = 1 << max_len
    lens = clamped_sorted.clone()
    kraft = kraft0.clone()

    # Phase A: lengthen the rarest (descending sorted position).
    for p in range(S - 1, -1, -1):
        l = lens[:, p]
        active = (p < n_used) & (kraft > full) & (l < max_len)
        r = (full >> l) - (kraft - full)
        l_new = torch.where(r <= 0, max_len,
                            torch.maximum(l, max_len - floor_log2(torch.clamp(r, min=1))))
        l_new = torch.where(active, torch.clamp(l_new, max=max_len), l)
        kraft = kraft - (full >> l) + (full >> l_new)
        lens[:, p] = l_new

    # Phase B: re-shorten the most frequent (ascending sorted position).
    for p in range(S):
        l = lens[:, p]
        active = p < n_used
        u = full >> l
        m = torch.clamp(full - kraft, min=0) // torch.clamp(u, min=1)
        d = torch.where(active, floor_log2(m + 1), 0)
        d = torch.minimum(d, torch.clamp(l - 1, min=0))
        kraft = kraft + u * ((1 << d) - 1)
        lens[:, p] = l - d
    return lens
