"""Times the RLE statistics kernel (``rle_stats``) on one CUDA card, at
every shape the one-shot path launches it with.

    python3 -m zultra_tpu_torch.rle_stats_bench

Records the arguments of every eager call of the RLE statistics during
one compression of the 4 MiB gzip case of smoke_golden.json (the calls
that a program's capture makes are left out: their tensors hold nothing
until a replay), and groups them by shape (mode, B lanes, M masks). For
each shape: its eager calls in the run, milliseconds per call by CUDA
events over back-to-back calls of its first input, and the device
microseconds per launch from a torch.profiler trace of all its recorded
calls, each call checked equal to the same wrapper on CPU copies of its
arguments (the plain form). Then the launch floor (one lane of no length,
one mask, through ``rle_histogram_masks``) and the weighted total over the
run: the sum of calls x device microseconds per launch.

It hooks the names ``entropy_torch`` calls the statistics by: the code
length tables (``rle_histogram_tables`` / ``rle_bits_tables``, the
concatenation in the kernel) where the tree has them, else the rows
already concatenated (``rle_histogram_masks`` / ``rle_bits_masks``). So it
runs on any tree of this package since the statistics took several masks
a launch: copy it into an older tree's ``zultra_tpu_torch/`` to time that
tree's kernel. Prints the card's name and power limit first and one JSON
object last; needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import defaultdict

import torch

from .device_pipeline import compress_device
from .mk_bench import GOLDEN, events_ms, launch_us
from .corpus import case_inputs
from .ops import entropy_torch, launch_counts, reset_launch_counts, rle_cuda

FUSED = hasattr(entropy_torch, "rle_histogram_tables")
NAMES = (("rle_histogram_tables", "rle_bits_tables") if FUSED
         else ("rle_histogram_masks", "rle_bits_masks"))


def record(dev) -> tuple[dict, int]:
    """(mode, B, M) -> [(wrapper, args)] of the eager calls, in call order,
    from one compression of the gzip case, the process's first (every
    program's first call runs eagerly); and the rle_stats launches that
    compression counted."""
    case = next(c for c in json.loads(GOLDEN.read_text())["cases"] if c["name"] == "gzip")
    data = case_inputs(case)[0]
    calls = defaultdict(list)
    real = [getattr(entropy_torch, n) for n in NAMES]

    def hook(mode, fn):
        def wrapper(*args):
            if not torch.cuda.is_current_stream_capturing():
                key = (mode, args[0].shape[0], len(args[-1]))
                calls[key].append((fn, tuple(a.clone() if torch.is_tensor(a) else tuple(a)
                                             for a in args)))
            return fn(*args)
        return wrapper

    for name, mode, fn in zip(NAMES, ("histogram", "bits"), real):
        setattr(entropy_torch, name, hook(mode, fn))
    try:
        reset_launch_counts()
        compress_device(data, case["flags"], case["block_size"], device=dev)
        torch.cuda.synchronize()
        launches = launch_counts()["rle_stats"]
    finally:
        for name, fn in zip(NAMES, real):
            setattr(entropy_torch, name, fn)
    return dict(sorted(calls.items(), key=lambda kv: (-kv[0][2], -kv[0][1], kv[0][0]))), launches


def same(got, want) -> bool:
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    calls, launches = record(dev)
    rows, total = [], 0.0
    for (mode, B, M), arg_list in calls.items():
        for fn, args in arg_list:
            if not same(fn(*args), fn(*(a.cpu() if torch.is_tensor(a) else a for a in args))):
                raise SystemExit(f"rle_stats {mode} {B} x {M}: the kernel differs from its "
                                 "plain form")
        fn, args = arg_list[0]
        row = {"mode": mode, "B": B, "M": M, "calls": len(arg_list),
               "ms": events_ms(lambda: fn(*args), 20),
               "device_us": launch_us([lambda c=c: c[0](*c[1]) for c in arg_list],
                                      "rle_stats", 10)}
        total += row["calls"] * (row["device_us"] or 0.0)
        rows.append(row)
        print(f"rle_stats {mode}, {B} lanes x {M} masks: {row['calls']} calls, "
              f"{row['ms']:.4f} ms a call (events), device {row['device_us']} us a launch")
    lens = torch.zeros((1, 19), dtype=torch.int32, device=dev)
    n_def = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_us = launch_us([lambda: rle_cuda.rle_histogram_masks(lens, n_def, (7,))],
                         "rle_stats", 50)
    print(f"launch floor (1 lane, n_def 0, 1 mask): device {floor_us} us")
    n_calls = sum(r["calls"] for r in rows)
    print(f"over the run: {n_calls} eager calls ({launches} rle_stats launches counted), "
          f"weighted device total {total:.2f} us")
    print(json.dumps({"card": smi, "entry": NAMES, "rows": rows, "launch_floor_us": floor_us,
                      "calls": n_calls, "launches": launches, "weighted_total_us": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
