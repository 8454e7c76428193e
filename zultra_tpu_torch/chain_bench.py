"""Times the chain kernel on one CUDA card, on the lanes that bound it.

    python3 -m zultra_tpu_torch.chain_bench [--sweep]

Lanes: the splitter's four 2^21 lanes of the 4 MiB gzip case of
smoke_golden.json (greedy row-0 steps, start = HALO), the lanes of every
planner bucket of that case (its first pass, recorded during one
compression), one 2^21 lane whose steps are all 3 (nothing merges), and
a 64 KiB zero run (greedy steps).
For each: milliseconds per ``chain_marks`` call by CUDA events over
back-to-back calls, and the device time of the chain's kernels per call
from a torch.profiler trace. It calls ``chain_marks(step, start,
length)`` only, so it runs on any tree of this package that has one
(copy it into an older tree's ``zultra_tpu_torch/`` to time that tree's
kernel). With ``--sweep`` (segment-parallel kernel only) it also times
each (segment, warm-up) pair of ``SWEEP`` and counts the segments it
anchored, re-walked and left unmerged. Prints the card's name and power
limit first and one JSON object last; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .corpus import case_inputs
from .device_pipeline import compress_device
from .ops import block_torch, chain_cuda
from .ops.matchfinder_torch import HALO, match_tables_device_stacked
from .ops.split_torch import split_bucket

GOLDEN = Path(__file__).resolve().parent / "smoke_golden.json"
SWEEP = [(256, 64), (256, 128), (512, 128), (512, 256), (512, 512), (1024, 256), (1024, 512),
         (2048, 512)]


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


def kernel_ms(fn, reps: int):
    """Device ms per call in kernels named ``chain*_kernel`` (trace)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if "::chain_" in ev.key and "_kernel(" in ev.key)
    return us / 1e3 / reps if us else None


def greedy_steps(buf: np.ndarray, spans, width: int, dev) -> torch.Tensor:
    lens, _ = match_tables_device_stacked(buf, spans, width, dev)
    rl = lens[:, :, 0]
    return torch.where(rl >= 3, rl, 1).to(torch.int32).contiguous()


def lanes(dev):
    """label -> (step, start, length) on the card."""
    case = next(c for c in json.loads(GOLDEN.read_text())["cases"] if c["name"] == "gzip")
    data = case_inputs(case)[0]
    corpus = np.frombuffer(data, np.uint8)
    real_chain = block_torch.chain_marks
    buckets = {}  # n_pad -> the planner's chain arguments of its first pass

    def recording_chain(*args):
        buckets.setdefault(args[0].shape[1], args)
        return real_chain(*args)

    block_torch.chain_marks = recording_chain
    try:
        compress_device(data, case["flags"], case["block_size"], device=dev)
    finally:
        block_torch.chain_marks = real_chain
    mbs = 1 << 20
    spans = [(lo, min(lo + mbs, len(corpus))) for lo in range(0, len(corpus), mbs)]
    W = len(spans)
    split = greedy_steps(corpus, spans, mbs, dev)
    split = torch.nn.functional.pad(split, (0, split_bucket(HALO + mbs) - split.shape[1]),
                                    value=1).contiguous()
    n3 = 1 << 21
    nz = 1 << 16
    zero = greedy_steps(np.zeros(nz, np.uint8), [(0, nz)], nz, dev)[:, HALO : HALO + nz]

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return {
        "splitter 4 x 2^21": (split, i32([HALO] * W),
                              i32([HALO + hi - lo for lo, hi in spans])),
        **{f"gzip bucket {k}": args for k, args in sorted(buckets.items())},
        "all-3 2^21": (torch.full((1, n3), 3, dtype=torch.int32, device=dev), i32([0]), i32([n3])),
        "zero run 64 KiB": (zero.contiguous(), i32([0]), i32([nz])),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    rows = []
    for label, (step, start, length) in lanes(dev).items():
        got = chain_cuda.chain_marks(step, start, length)
        want = chain_cuda.chain_marks_plain(step.cpu(), start.cpu(), length.cpu())
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"{label}: the kernel's marks differ from pointer doubling")
        row = {"lanes": label, "shape": list(step.shape),
               "ms": events_ms(lambda: chain_cuda.chain_marks(step, start, length), 5),
               "device_ms": kernel_ms(lambda: chain_cuda.chain_marks(step, start, length), 5)}
        print(f"{label}: {row['ms']:.4f} ms a call (events), device {row['device_ms']} ms")
        if args.sweep:
            row["sweep"] = []
            for seg, warm in SWEEP:
                def call():
                    return chain_cuda.chain_marks(step, start, length, status=True, seg=seg,
                                                  warm=warm)
                marks, st = call()
                if not torch.equal(marks.cpu(), want):
                    raise SystemExit(f"{label} seg {seg} warm {warm}: marks differ")
                counts = {name: int(st.eq(getattr(chain_cuda, f"ST_{name.upper()}")).sum())
                          for name in ("exact", "anchored", "rerun", "unmerged")}
                s = {"seg": seg, "warm": warm, "ms": events_ms(call, 5),
                     "device_ms": kernel_ms(call, 5), **counts}
                row["sweep"].append(s)
                print(f"  seg {seg} warm {warm}: {s['ms']:.4f} ms, device {s['device_ms']} ms; "
                      f"{counts}")
        rows.append(row)
    print(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
