"""Where the one-shot path's time goes on one CUDA card.

    python3 -m zultra_tpu_torch.profile_stages

Compresses the gzip case of smoke_golden.json (the 4 MiB mixed corpus,
four 1 MiB windows) after one warm-up call, three ways:

1. untraced: host clock around the call, ending in a synchronize;
2. stage timing: each stage function wrapped in torch.cuda.synchronize()
   and the host clock (nested stages are counted inside their parent);
3. traced: torch.profiler with CUDA activity only,
   for the device's busy time, the kernel time by name, and the device
   time per launch of each of the port's own kernels.

Prints the card's name and power limit first and one JSON object last.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from . import device_pipeline
from .corpus import case_inputs
from .ops import (
    block_torch,
    entropy_torch,
    launch_counts,
    matchfinder_torch,
    reset_launch_counts,
    split_torch,
)

GOLDEN = Path(__file__).resolve().parent / "smoke_golden.json"

# (module, function name, stage label); a label with ": " is part of the
# stage before its colon.
STAGES = [
    (device_pipeline, "match_tables_device_stacked", "match tables"),
    (matchfinder_torch, "walk_segments", "match tables: walk"),
    (device_pipeline, "split_batch", "block split"),
    (split_torch, "dynamic_cost", "block split: dynamic_cost"),
    (split_torch, "chain_marks", "block split: chain"),
    (split_torch, "prefix_tables", "block split: prefix_tables"),
    (device_pipeline, "plan_blocks_device_multi", "block plans"),
    (block_torch, "token_hist", "block plans: token_hist"),
    (block_torch, "dynamic_cost", "block plans: dynamic_cost"),
    (block_torch, "build_lengths", "block plans: build_lengths"),
    (block_torch, "run_dp", "block plans: DP"),
    (block_torch, "post_optimize", "block plans: post_optimize"),
    (block_torch, "dynamic_cost_given", "block plans: dynamic_cost_given"),
    (block_torch, "optimize_for_rle", "block plans: optimize_for_rle"),
    (block_torch, "mask_search", "block plans: mask_search"),
    (block_torch, "canonical_codewords", "block plans: canonical_codewords"),
    (block_torch, "emit_tokens", "block plans: emit"),
    (device_pipeline, "emit_window_from_plan", "host splice"),
    # Inside the dynamic costs of both stages and the mask search; not
    # part of the wall's sum.
    (entropy_torch, "rle_histogram_masks", "(in split and plans) rle_stats histograms"),
    (entropy_torch, "rle_bits_masks", "(in split and plans) rle_stats bits"),
]


def _timed(fn, label, seconds):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[label] += time.perf_counter() - t0
        return out
    return wrapper


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    case = next(c for c in json.loads(GOLDEN.read_text())["cases"] if c["name"] == "gzip")
    data, _ = case_inputs(case)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = device_pipeline.compress_device(data, case["flags"], case["block_size"],
                                              device=dev)
        torch.cuda.synchronize()
        if len(out) != case["out_len"]:
            raise SystemExit(f"output length {len(out)} != golden {case['out_len']}")
        return time.perf_counter() - t0

    run()  # warm-up: kernel build, allocator, caches
    reset_launch_counts()
    wall = run()
    launches = launch_counts()
    print(f"untraced: {wall:.3f} s, {len(data) / 1e6 / wall:.4f} MB/s; launches {launches}")

    seconds = defaultdict(float)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in STAGES]
    for mod, name, label in STAGES:
        setattr(mod, name, _timed(getattr(mod, name), label, seconds))
    try:
        staged = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(f"stage-timed: {staged:.3f} s")
    for _, _, label in STAGES:
        print(f"  {label}: {seconds[label]:.4f} s")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = run()
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((us / 1e6, ev.count, ev.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    print(f"traced: {traced:.3f} s wall, device busy {busy:.4f} s, idle share "
          f"{1 - busy / traced:.4f}")
    for s, count, key in kernels[:15]:
        print(f"  {s:.4f} s  {count:7d}x  {key[:90]}")
    # A port kernel is ``{name}_kernel`` or, where one call makes several
    # launches, ``{name}_{phase}_kernel`` (the DP's spec, check, fixup).
    ours = [{"name": m.group(1), "s": s, "count": c, "us_per_launch": s / c * 1e6}
            for name in launches for s, c, k in kernels
            if (m := re.search(rf"::({name}(?:_[a-z]+)?)_kernel\(", k))]
    for k in ours:
        print(f"  port kernel {k['name']}: {k['s']:.6f} s over {k['count']} launches, "
              f"{k['us_per_launch']:.2f} us each")
    print(json.dumps({
        "card": smi, "mb": len(data) / 1e6, "wall_s": wall, "mb_per_s": len(data) / 1e6 / wall,
        "launches": launches, "stage_timed_wall_s": staged, "stages_s": dict(seconds),
        "traced_wall_s": traced, "device_busy_s": busy, "idle_share_traced": 1 - busy / traced,
        "idle_share_untraced_derived": 1 - busy / wall, "port_kernels": ours,
        "top_kernels": [{"s": s, "count": c, "name": k[:120]} for s, c, k in kernels[:15]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
