"""Times the walk kernel on one CUDA card, on the segments that bound it.

    python3 -m zultra_tpu_torch.walk_bench [--sweep] [--reads]

Segments (rank-order words from ``salcp_batch``, n = HALO + SEG_CORE +
TAIL a segment): the 128 segments of the 4 MiB gzip case of
smoke_golden.json, cut as the one-shot path cuts its four 1 MiB windows
(the main path's call); and single segments whose every word is a zero
run, a period-3 run (7, 7, 9, ...), seeded random bytes, and the 64th
gzip segment walked over a partial core (core_len 20,423, no multiple of
any chunk size). For each: milliseconds per ``walk_segments`` call by
CUDA events over back-to-back calls, the device time of each walk kernel
per launch from a torch.profiler trace, and the byte bound. Single
segments are checked equal to the plain walk. It calls
``walk_segments(salcp, halo, core_len)`` only, so it runs on any tree of
this package that has one (copy it into an older tree's
``zultra_tpu_torch/`` to time that tree's kernel). With ``--sweep``
(chunked kernel only) it also times each chunk size of ``SWEEP``, checks
its rows equal to the default's, and gives its scratch bytes and those
of a 16-window device batch of 1 MiB windows. With ``--reads`` it counts
the plain walk's table reads per position on one gzip segment (host).
Prints the card's name and power limit first and one JSON object last;
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .corpus import case_inputs
from .ops import walk_cuda
from .ops.matchfinder_torch import HALO, SEG_CORE, TAIL, build_segments, salcp_batch

GOLDEN = Path(__file__).resolve().parent / "smoke_golden.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SWEEP = [1024, 2048, 4096, 8192, 32768]
PARTIAL_CORE = 20423
BATCH_SEGMENTS = 16 * ((1 << 20) // SEG_CORE)  # a 16-window device batch of 1 MiB windows


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


def kernel_ms(fn, reps: int) -> dict:
    """Device ms per launch of each kernel named ``walk*_kernel``, each
    launched once a call: a trace of ``reps`` calls, averaged over the
    launches the trace recorded (a trace may drop some)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"::(walk\w*_kernel)\(", ev.key)
        if m and ev.self_device_time_total and ev.count:
            out[m.group(1)] = ev.self_device_time_total / ev.count / 1e3
    return out


def bound_ms(S: int, n: int, core_len: int) -> float:
    """Read every rank-order word once, write every row once."""
    return (S * n + S * core_len * 8) * 4 / HBM_BYTES_PER_S * 1e3


def segments(dev) -> dict:
    """label -> (salcp (S, n) int32 on ``dev``, halo, core_len)."""
    case = next(c for c in json.loads(GOLDEN.read_text())["cases"] if c["name"] == "gzip")
    corpus = np.frombuffer(case_inputs(case)[0], np.uint8)
    mbs = 1 << 20
    spans = [(lo, min(lo + mbs, len(corpus))) for lo in range(0, len(corpus), mbs)]
    segbufs, _ = build_segments(corpus, spans, SEG_CORE)
    gzip = salcp_batch(torch.from_numpy(segbufs).to(dev))
    n = HALO + SEG_CORE + TAIL

    def one(buf):
        return salcp_batch(torch.from_numpy(buf.astype(np.int32)[None]).to(dev))

    return {
        f"gzip {len(segbufs)} segments": (gzip, HALO, SEG_CORE),
        "zero run": (one(np.zeros(n)), HALO, SEG_CORE),
        "period 3": (one(np.resize(np.array([7, 7, 9]), n)), HALO, SEG_CORE),
        "random bytes": (one(np.random.default_rng(9).integers(0, 256, n)), HALO, SEG_CORE),
        f"partial core {PARTIAL_CORE}": (gzip[64:65].contiguous(), HALO, PARTIAL_CORE),
    }


def plain_reads(words: list, n: int, halo: int, core_len: int) -> dict:
    """Table reads of the plain walk (the reference's order, from 0), per
    position: all positions and core positions."""
    counts = [0]

    class Counted(list):
        def __getitem__(self, i):
            counts[0] += 1
            return list.__getitem__(self, i)

    T, P = map(Counted, walk_cuda._tree(words, n))
    rows = []
    per = []
    for p in range(halo + core_len):
        before = counts[0]
        walk_cuda._visit(T, P, p, P[p], 8 if p >= halo else 0, halo, rows)
        per.append(counts[0] - before)
    return {"all": sum(per) / len(per), "core": sum(per[halo:]) / max(1, core_len)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reads", action="store_true")
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
    for label, (salcp, halo, core) in segments(dev).items():
        S, n = salcp.shape

        def call():
            return walk_cuda.walk_segments(salcp, halo, core)

        got = call()
        row = {"segments": label, "shape": [S, n], "core_len": core,
               "bound_ms": bound_ms(S, n, core)}
        if S == 1:
            t0 = time.perf_counter()
            want = walk_cuda.walk_segments_plain(salcp.cpu(), halo, core)
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"{label}: the kernel's rows differ from the plain walk")
        row["ms"] = events_ms(call, 3)
        row["device_ms"] = kernel_ms(call, 3)
        print(f"{label}: {row['ms']:.4f} ms a call (events), device {row['device_ms']}, "
              f"bound {row['bound_ms']:.4g} ms")
        if args.reads and S > 1:
            row["plain_reads_per_position"] = plain_reads(salcp[S // 2].tolist(), n, halo, core)
            print(f"  plain walk reads per position: {row['plain_reads_per_position']}")
        if args.sweep:
            row["sweep"] = []
            for chunk in SWEEP:
                def call_k():
                    return walk_cuda.walk_segments(salcp, halo, core, chunk)

                if not torch.equal(call_k(), got):
                    raise SystemExit(f"{label} chunk {chunk}: rows differ from the default's")
                s = {"chunk": chunk, "ms": events_ms(call_k, 3), "device_ms": kernel_ms(call_k, 3),
                     "scratch_bytes": walk_cuda.scratch_bytes(S, n, core, chunk),
                     "batch_scratch_bytes": walk_cuda.scratch_bytes(BATCH_SEGMENTS, n, SEG_CORE,
                                                                     chunk)}
                row["sweep"].append(s)
                print(f"  chunk {chunk}: {s['ms']:.4f} ms, device {s['device_ms']}; scratch "
                      f"{s['scratch_bytes']} B, 16-window batch {s['batch_scratch_bytes']} B")
        rows.append(row)
    print(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
