"""Greedy token-chain marks (kernel ``csrc/chain.cu``) and their plain
PyTorch version.

For each lane, the chain p0 = start, p_{k+1} = p_k + max(step[p_k], 1)
marks every position it visits below ``length`` — the token starts of a
greedy or chosen parse (zultra src/blockdeflate.c:333-361). Same
contract as zultra_tpu.ops.chain_pallas.chain_marks_pallas and the
pointer-doubling masks of block_jax._chain_mask / split_jax.
"""

from __future__ import annotations

import math

import torch

from .. import _build

launches = 0  # kernel launches since the last reset


def chain_marks(step: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """step (B, n) int32 hop sizes, start/length (B,) int32 -> (B, n)
    bool, True at every chain position p with start <= p < length."""
    global launches
    if step.device.type == "cpu":
        return chain_marks_plain(step, start, length)
    for name, t, nd in (("step", step, 2), ("start", start, 1), ("length", length, 1)):
        _build.check_cuda(f"chain {name}", t, torch.int32, nd)
    B, n = step.shape
    if start.shape[0] != B or length.shape[0] != B:
        raise ValueError("chain: start/length must have one entry per lane")
    marks = torch.zeros((B, n), dtype=torch.int32, device=step.device)
    _build.launch("zt_chain", step.data_ptr(), start.data_ptr(), length.data_ptr(),
                  marks.data_ptr(), B, n)
    launches += 1
    return marks == 1


def chain_marks_plain(step: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Pointer doubling: after r rounds every position reachable from
    ``start`` within 2^r hops is marked."""
    B, n = step.shape
    dev = step.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    nxt = torch.clamp(idx + torch.clamp(step.to(torch.int64), min=1), max=n)
    jmp = torch.cat([nxt, torch.full((B, 1), n, dtype=torch.int64, device=dev)], dim=1)
    mark = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    mark.scatter_(1, torch.clamp(start.to(torch.int64), 0, n)[:, None], 1)
    for _ in range(max(1, int(math.ceil(math.log2(n + 1))) + 1)):
        hop = torch.zeros_like(mark).scatter_reduce(1, jmp, mark, "amax")
        mark = torch.maximum(mark, hop)
        jmp = torch.gather(jmp, 1, jmp)
    return (mark[:, :n] == 1) & (idx >= start[:, None]) & (idx < length[:, None])
