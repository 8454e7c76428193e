"""Times the MK and Kraft kernels on one CUDA card, at every shape the
one-shot path launches them with.

    python3 -m zultra_tpu_torch.mk_bench [--layouts]

Records the inputs of every ``mk_phase12`` and ``kraft_limit`` call
during one compression of the 4 MiB gzip case of smoke_golden.json, and
groups them by shape (B lanes, S symbols, Kraft's max_len), with the
smoke's skewed 4096 x 288 batch (weights 2^0..2^20) beside them. For
each shape: its launches in the run, milliseconds per call by CUDA
events over back-to-back calls of its first input (checked equal to the
plain form), the device microseconds per launch from a torch.profiler
trace of all its recorded calls, and, for Kraft, the lanes that need the
repair. Then the launch floor (a call that does almost no work: B = 1,
S = 2, n_used 2, through the same wrapper) and the weighted totals: the
sum over the run of launches x device microseconds per launch. It calls
``mk_phase12(a0, n_used)`` and ``kraft_limit(lens, n_used, kraft0,
max_len)`` only, so it runs on any tree of this package (copy it into an
older tree's ``zultra_tpu_torch/`` to time that tree's kernels). With
``--layouts`` (this tree only) it also gives each MK shape's device time
in both layouts, a warp per lane and a thread per lane, and sweeps B at
S = 288, 32 and 19 for the crossover. Prints the card's name and power
limit first and one JSON object last; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .corpus import case_inputs
from .device_pipeline import compress_device
from .ops import mk_cuda
from .ops.entropy_torch import kraft_inputs, mk_inputs, mk_lengths

GOLDEN = Path(__file__).resolve().parent / "smoke_golden.json"
SWEEP_B = [1, 4, 16, 32, 64, 84, 128, 256, 512, 1024, 1680, 4096]


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


def launch_us(calls, kernel: str, reps: int = 3):
    """Device microseconds per launch of the kernels named
    ``{kernel}*_kernel`` over ``reps`` passes of ``calls`` (a trace,
    averaged over the launches it recorded; a trace that recorded none is
    taken again, up to three times); None if none did."""
    name = re.compile(rf"::{kernel}\w*_kernel\(")
    for _ in range(3):
        for fn in calls[:1]:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in calls:
                    fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if name.search(ev.key) and ev.count]
        n = sum(ev.count for ev in evs)
        if n:
            return sum(ev.self_device_time_total for ev in evs) / n
    return None


def record(dev) -> dict:
    """(kind, B, S, max_len) -> list of recorded argument tuples, in call
    order, from one compression of the gzip case."""
    case = next(c for c in json.loads(GOLDEN.read_text())["cases"] if c["name"] == "gzip")
    data = case_inputs(case)[0]
    calls = defaultdict(list)
    real_mk, real_kraft = mk_cuda.mk_phase12, mk_cuda.kraft_limit

    def rec_mk(a0, n_used):
        calls[("mk12", *a0.shape, None)].append((a0.clone(), n_used.clone()))
        return real_mk(a0, n_used)

    def rec_kraft(lens, n_used, kraft0, max_len):
        calls[("kraft", *lens.shape, max_len)].append(
            (lens.clone(), n_used.clone(), kraft0.clone(), max_len))
        return real_kraft(lens, n_used, kraft0, max_len)

    mk_cuda.mk_phase12, mk_cuda.kraft_limit = rec_mk, rec_kraft
    try:
        compress_device(data, case["flags"], case["block_size"], device=dev)
    finally:
        mk_cuda.mk_phase12, mk_cuda.kraft_limit = real_mk, real_kraft
    return dict(sorted(calls.items(),
                       key=lambda kv: (kv[0][0], -kv[0][2], kv[0][1], kv[0][3] or 0)))


def skewed(dev, B=4096, S=288) -> torch.Tensor:
    """The smoke's skewed batch (4096 x 288): weights 2^0..2^20, seed 0."""
    rng = np.random.default_rng(0)
    return torch.from_numpy((2 ** rng.integers(0, 21, (B, S))).astype(np.int32)).to(dev)


def run(kind, args):
    return mk_cuda.mk_phase12(*args) if kind == "mk12" else mk_cuda.kraft_limit(*args)


def plain(kind, args):
    return mk_cuda.mk_phase12_plain(*args) if kind == "mk12" else mk_cuda.kraft_limit_plain(*args)


def layout_call(args, warp: bool):
    return lambda: mk_cuda._launch_mk12(*args, warp)


def shape_row(kind, key, arg_list, layouts: bool) -> dict:
    args = arg_list[0]
    if not torch.equal(run(kind, args), plain(kind, args)):
        raise SystemExit(f"{kind} {key}: the kernel differs from its plain form")
    row = {"kernel": kind, "B": key[1], "S": key[2], "max_len": key[3],
           "launches": len(arg_list),
           "ms": events_ms(lambda: run(kind, args), 20),
           "device_us": launch_us([lambda a=a: run(kind, a) for a in arg_list], kind)}
    if kind == "mk12":
        row["mean_n_used"] = float(torch.cat([a[1] for a in arg_list]).float().mean())
    else:
        full = 1 << key[3]
        row["repair_lanes"] = sum(int((a[2] > full).sum()) for a in arg_list)
        row["lanes"] = sum(int(a[2].numel()) for a in arg_list)
    if layouts and kind == "mk12":
        row["layout_device_us"] = {
            name: launch_us([layout_call(a, warp) for a in arg_list], kind)
            for name, warp in (("warp", True), ("lanes", False))}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layouts", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    calls = record(dev)
    sk = skewed(dev)
    sk_mk = mk_inputs(sk)[:2]
    sk_kraft = (*kraft_inputs(mk_lengths(sk), 15)[:3], 15)
    rows = []
    totals = {"mk12": 0.0, "kraft": 0.0}
    launches = {"mk12": 0, "kraft": 0}
    for key, arg_list in calls.items():
        kind = key[0]
        row = shape_row(kind, key, arg_list, opts.layouts)
        rows.append(row)
        totals[kind] += row["launches"] * (row["device_us"] or 0.0)
        launches[kind] += row["launches"]
        print(f"{kind} B {row['B']} S {row['S']}" + (f" max_len {row['max_len']}" if row["max_len"]
                                                     else "")
              + f": {row['launches']} launches, {row['ms']:.4f} ms a call (events), device "
              f"{row['device_us']} us a launch" + (f", {row['repair_lanes']} of {row['lanes']} "
                                                    "lanes to repair" if kind == "kraft" else "")
              + (f"; layouts {row['layout_device_us']}" if "layout_device_us" in row else ""))
    extra = [shape_row("mk12", ("mk12", 4096, 288, None), [sk_mk], opts.layouts),
             shape_row("kraft", ("kraft", 4096, 288, 15), [sk_kraft], opts.layouts)]
    for row in extra:
        row["batch"] = "skewed 4096 x 288"
        print(f"skewed {row['kernel']}: {row['ms']:.4f} ms a call, device {row['device_us']} us")

    one = torch.ones((1, 2), dtype=torch.int32, device=dev)
    two = torch.full((1,), 2, dtype=torch.int32, device=dev)
    floor = {}
    for kind, args in (("mk12", (one, two)),
                       ("kraft", (one, two, torch.full((1,), 1 << 15, dtype=torch.int32,
                                                       device=dev), 15))):
        floor[kind] = {"ms": events_ms(lambda: run(kind, args), 200),
                       "device_us": launch_us([lambda: run(kind, args)], kind, 50)}
        print(f"launch floor {kind} (B 1, S 2, n_used 2): {floor[kind]['ms']:.4f} ms a call, "
              f"device {floor[kind]['device_us']} us")
    print(f"weighted totals over the run: mk12 {totals['mk12']:.2f} us ({launches['mk12']} "
          f"launches), kraft {totals['kraft']:.2f} us ({launches['kraft']} launches)")

    sweep = []
    if opts.layouts:
        for S in (288, 32, 19):
            h = skewed(dev, max(SWEEP_B), S)
            a0, n_used = mk_inputs(h)[:2]
            for B in SWEEP_B:
                args = (a0[:B].contiguous(), n_used[:B].contiguous())
                s = {"S": S, "B": B, **{name: launch_us([layout_call(args, warp)], "mk12", 10)
                                        for name, warp in (("warp", True), ("lanes", False))}}
                sweep.append(s)
                print(f"mk12 layout sweep, skewed: {s}")
    print(json.dumps({"card": smi, "rows": rows, "skewed": extra, "launch_floor": floor,
                      "weighted_total_us": totals, "launches": launches,
                      "layout_sweep": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
