"""Times the suffix doubling on one CUDA card at the match program's batch
shapes, the kernel round (``csrc/suffix.cu``) beside the plain round.

    python3 -m zultra_tpu_torch.suffix_bench [--out PATH]

Batches, cut as the match program cuts them (``upload_batch``, then
``segments_from_corpus``): 16 windows of 1 MiB of mixed data (512
segments of 65,794 positions), 16 windows of 2 MiB of text (1024), one
48,944-byte text window (2), each from content seed 0. For each: the
round after which the plain rounds find every segment's ranks distinct
and the rounds each segment ran (the kernel's count), the kernel's
doubling (all num_levels rounds, 8 stored) checked equal to the plain
rounds' (suffix order, the 9 stored rank tables, the counts), and by
CUDA events: each round alone on both routes (the median of 3 passes),
both doublings whole, and ``torch.sort`` of one round's packed keys
alone. The bound: 16 bytes a position a round (the ranks and the order
read and written once) at the card's memory rate. Prints the card's
name and power limit first and one JSON object last (also to ``--out``);
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .corpus import mixed_corpus, text_corpus
from .ops import launch_counts, reset_launch_counts, suffix_torch
from .ops import matchfinder_torch as mt

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
STORE = 8  # stored levels, as the match program keeps them
SHAPES = [("mixed, 16 x 1 MiB", "mixed", 16, 1 << 20), ("text, 16 x 2 MiB", "text", 16, 2 << 20),
          ("text, 1 x 48,944 B", "text", 1, 48944)]


def batch(content: str, W: int, mbs: int, dev) -> torch.Tensor:
    make = mixed_corpus if content == "mixed" else text_corpus
    corpus = np.frombuffer(make(W * mbs, seed=0), np.uint8)
    spans = [(i * mbs, (i + 1) * mbs) for i in range(W)]
    corpus_dev, meta, W, k = mt.upload_batch(corpus, spans, mbs, dev)
    return mt.segments_from_corpus(corpus_dev, meta[: W * k], mt.SEG_LEN)


def plain_rounds(bufs: torch.Tensor, events=None):
    """Every round by ``suffix_torch._round``: (sa, stored ranks, flags a
    round); ``events`` (levels + 1 CUDA events) recorded around each."""
    rank = bufs.to(torch.int32)
    rows, flags, sa = [rank], [], None
    if events:
        events[0].record()
    for level in range(suffix_torch.num_levels(bufs.shape[1])):
        sa, rank, distinct = suffix_torch._round(rank, 1 << level)
        if level < STORE:
            rows.append(rank)
        flags.append(distinct)
        if events:
            events[level + 1].record()
    return sa, torch.stack(rows), flags


def kernel_rounds(bufs: torch.Tensor, events=None):
    """``doubling_rounds_fixed``'s rounds one by one, ``events`` around each."""
    st, ranks = None, torch.empty((STORE + 1, *bufs.shape), dtype=torch.int32,
                                  device=bufs.device)
    ranks[0] = bufs
    if events:
        events[0].record()
    for level in range(suffix_torch.num_levels(bufs.shape[1])):
        if level < STORE:
            st = suffix_torch._step(st, ranks[level], level, ranks[level + 1])
        else:
            out = st.rank if level > STORE else torch.empty_like(st.rank)
            st = suffix_torch._step(st, st.rank, level, out)
        if events:
            events[level + 1].record()
    return st.sa, ranks, st.run


def per_round_ms(fn, bufs, levels: int, passes: int = 3) -> list:
    """Median ms of each round over ``passes`` passes of ``fn``."""
    times = []
    for _ in range(passes):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(levels + 1)]
        fn(bufs, ev)
        torch.cuda.synchronize()
        times.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    return [statistics.median(col) for col in zip(*times)]


def events_ms(fn, reps: int) -> float:
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("suffix_bench: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rows = []
    for label, content, W, mbs in SHAPES:
        bufs = batch(content, W, mbs, dev)
        S, n = bufs.shape
        levels = suffix_torch.num_levels(n)
        sa_p, ranks_p, flags = plain_rounds(bufs)
        flags = torch.stack(flags).cpu()
        all_at = next((lv + 1 for lv in range(levels) if bool(flags[lv].all())), None)
        first = [next((lv + 1 for lv in range(levels) if bool(flags[lv, s])), levels)
                 for s in range(S)]
        row = {"batch": label, "segments": S, "n": n, "levels": levels,
               "distinct_after_round": all_at,
               "first_distinct_round": dict(sorted(
                   (str(r), first.count(r)) for r in set(first))),
               "plain_round_ms": per_round_ms(plain_rounds, bufs, levels),
               "plain_doubling_ms": events_ms(lambda: plain_rounds(bufs), 3)}
        key = (ranks_p[1].to(torch.int64) * (n + 257) + 1)  # a round's packed keys, shaped
        row["torch_sort_ms"] = events_ms(lambda: torch.sort(key, dim=1, stable=True), 3)
        reset_launch_counts()
        sa_k, ranks_k, run = kernel_rounds(bufs)
        torch.cuda.synchronize()
        row["launches"] = launch_counts()["suffix_round"]
        if not (torch.equal(sa_k, sa_p) and torch.equal(ranks_k, ranks_p)
                and run.cpu().tolist() == first):
            raise SystemExit(f"suffix_bench [{label}]: the kernel's doubling differs from the "
                             "plain rounds'")
        row["kernel_round_ms"] = per_round_ms(kernel_rounds, bufs, levels)
        row["kernel_doubling_ms"] = events_ms(lambda: kernel_rounds(bufs), 3)
        row["rounds_run"] = int(run.sum())
        row["bound_round_ms"] = 16 * S * n / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        print(f"{label}: {S} x {n}, ranks distinct after round {all_at} of {levels} "
              f"(segments by first distinct round {row['first_distinct_round']}); plain "
              f"doubling {row['plain_doubling_ms']:.3f} ms, torch.sort of one round "
              f"{row['torch_sort_ms']:.3f} ms; kernel doubling {row['kernel_doubling_ms']:.3f} ms, "
              f"equal; rounds run {row['rounds_run']} of {S * levels}; bound a round "
              f"{row['bound_round_ms']:.4f} ms")
        for name in ("plain_round_ms", "kernel_round_ms"):
            print(f"  {name}: " + " ".join(f"{v:.3f}" for v in row[name]))
        del bufs, sa_p, ranks_p, key, sa_k, ranks_k
        torch.cuda.empty_cache()
    out = {"card": smi, "rows": rows}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
