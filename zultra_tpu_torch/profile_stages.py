"""Where the one-shot path's time goes on one CUDA card.

    python3 -m zultra_tpu_torch.profile_stages

Compresses the gzip case of smoke_golden.json (the 4 MiB mixed corpus,
four 1 MiB windows) after a first call (the kernels' build, every
program's shapes met eagerly) and a second (every program's capture,
``ops/programs.py``), four ways:

1. untraced: host clock around the call, ending in a synchronize, with
   the port's tracer on (``profiling.enable``): its spans and counters
   are printed after the call;
2. stage timing: the top-level stages wrapped in torch.cuda.synchronize()
   and the host clock, the planner and the splitter replayed as graphs;
3. eager stage timing: ``programs.run`` bypassed, so that the planner and
   the splitter run their functions eagerly, op by op, and their
   sub-stages can be wrapped too (a synchronize cannot sit inside a
   capture or a replay); labelled "eager" in the output;
4. traced: torch.profiler with CUDA activity only, for the kernel time
   by name and the device time per launch of each of the port's own
   kernels (the device's busy and idle time by span is what
   ``portbench``'s traced run reads).

Also the first and second calls' seconds, the peak memory the allocator
reserved by the end of the untraced call, and the programs: their
number, the graph pool's bytes, each one's capture ms, each one
replayed against an eager call of its function on the untraced call's
inputs (equal; the replay's device ms by events), and one traced replay
of each: its launches and their device time, and those of torch's own
ops apart from the port's kernels, summed by program function. The eager run splits
the match tables into the upload, the segments, the 8 stored doubling
rounds and the rounds past them, the LCP, the walk and the lanes, and the
block plans into their passes (the DP into its lane preparation and the
DP kernel). Last,
for every device batch of every golden case: the round after which the
ranks were distinct (where the early exit would stop), the rounds past 8
alone and the match program's replay (device ms by events).

    python3 -m zultra_tpu_torch.profile_stages --fresh one-shot
    python3 -m zultra_tpu_torch.profile_stages --fresh cli
    python3 -m zultra_tpu_torch.profile_stages --fresh quicktest

time what a process that compresses once pays, with the kernels built
by an earlier process: ``one-shot``, three ``compress_device`` calls of
the gzip case, the first of them the process's first (each call's
seconds); ``cli``, the CLI's ``-gzip -c`` on the gzip case's input
written to a file (its seconds, in this process: the CLI's ``Stream``);
``quicktest``, three runs of the CLI's ``-quicktest`` (59 compressions
of at most 4 KiB, one window each: the first run meets their shapes
eagerly and captures those that come twice, later runs replay; each
run's seconds).

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
import tempfile
import time
import zlib
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import cli, device_pipeline, profiling
from .corpus import case_inputs
from .ops import (
    block_torch,
    dp_cuda,
    entropy_torch,
    matchfinder_torch,
    split_torch,
    suffix_torch,
)

from .ops import programs
from .stream import clamp_block_size

GOLDEN = Path(__file__).resolve().parent / "smoke_golden.json"

# (module, function name, stage label); a label with ": " is part of the
# stage before its colon. The top-level stages are outside every program.
STAGES = [
    (device_pipeline, "match_stacks", "match tables"),
    (matchfinder_torch, "upload_batch", "match tables: upload"),
    (device_pipeline, "split_batch", "block split"),
    (device_pipeline, "plan_blocks_device_multi", "block plans"),
    (device_pipeline, "emit_window_from_plan", "host splice"),
]
# Inside the programs: timed on the eager run alone.
SUBSTAGES = [
    (matchfinder_torch, "segments_from_corpus", "match tables: segments"),
    (suffix_torch, "stored_rounds", "match tables: doubling, the 8 stored rounds"),
    (suffix_torch, "later_rounds", "match tables: doubling, the rounds past 8"),
    (matchfinder_torch, "adjacent_lcp", "match tables: LCP"),
    (matchfinder_torch, "walk_segments", "match tables: walk"),
    (matchfinder_torch, "assemble_lanes", "match tables: lanes"),
    (split_torch, "dynamic_cost", "block split: dynamic_cost"),
    (split_torch, "chain_marks", "block split: chain"),
    (split_torch, "prefix_tables", "block split: prefix_tables"),
    (block_torch, "token_hist", "block plans: token_hist"),
    (block_torch, "dynamic_cost", "block plans: dynamic_cost"),
    (block_torch, "build_lengths", "block plans: build_lengths"),
    (block_torch, "run_dp", "block plans: DP"),
    (dp_cuda, "prep_lanes", "block plans: DP: prep_lanes"),
    (dp_cuda, "dp_choices", "block plans: DP: the DP kernel"),
    (block_torch, "post_optimize", "block plans: post_optimize"),
    (block_torch, "dynamic_cost_given", "block plans: dynamic_cost_given"),
    (block_torch, "optimize_for_rle_pair", "block plans: optimize_for_rle"),
    (block_torch, "mask_search", "block plans: mask_search"),
    (block_torch, "canonical_codewords", "block plans: canonical_codewords"),
    (block_torch, "emit_tokens", "block plans: emit"),
    # Inside the dynamic costs of both stages and the mask search; not
    # part of the wall's sum.
    (entropy_torch, "rle_histogram_tables", "(in split and plans) rle_stats histograms"),
    (entropy_torch, "rle_bits_tables", "(in split and plans) rle_stats bits"),
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


def _staged(run, stages, eager: bool):
    """(wall, {label: seconds}) of one run with ``stages`` wrapped; with
    ``eager`` every program's function is called directly."""
    seconds = defaultdict(float)
    patches = [(mod, name, _timed(getattr(mod, name), label, seconds))
               for mod, name, label in stages]
    if eager:
        patches.append((programs, "run", lambda fn, *inputs, **statics: fn(*inputs, **statics)))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        wall = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return wall, {label: seconds[label] for _, _, label in stages}


def _replay_launches(dev, port: list) -> dict:
    """{program function: its graphs, then over one traced replay of each:
    kernel launches (copies and fills included) and their device ms, those
    of torch's own (not a port kernel, ``port`` the kernel names), and
    torch's launches by kernel name (the first 60 characters)}. A trace
    may drop launches: each replay is traced until it shows one."""
    pattern = re.compile(rf"::({'|'.join(port)})(?:_[a-z]+)?_kernel")
    progs = programs.device_programs(dev)
    rows = {}
    with progs.lock, progs.graphs.current():
        for p in progs.programs.values():
            row = rows.setdefault(p.fn.__qualname__, dict(
                dict.fromkeys(("graphs", "launches", "device_ms", "torch_launches",
                               "torch_device_ms"), 0), torch_by_name=defaultdict(int)))
            row["graphs"] += 1
            for _ in range(3):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    progs.graphs.replay(p.graph)
                    torch.cuda.synchronize()
                evs = [ev for ev in prof.key_averages() if ev.count
                       and ev.device_type == torch.autograd.DeviceType.CUDA]
                if evs:
                    break
            for ev in evs:
                ms = ev.self_device_time_total / 1e3
                row["launches"] += ev.count
                row["device_ms"] += ms
                if not pattern.search(ev.key):
                    row["torch_launches"] += ev.count
                    row["torch_device_ms"] += ms
                    row["torch_by_name"][ev.key[:60]] += ev.count
    return rows


def _golden_match(case: dict, dev) -> list:
    """One row a device batch of a golden case's one-shot run: its shape,
    the round after which every segment's ranks were distinct (where the
    early exit stops, at 8 at the earliest; the program runs all of
    ``num_levels``), the rounds past 8 alone on the card (events), and the
    match program's replay and eager ms on the batch's inputs (the case
    run twice before: its shapes captured)."""
    data, dictionary = case_inputs(case)
    for _ in range(2):
        device_pipeline.compress_device(data, case["flags"], case["block_size"], dictionary,
                                        device=dev)
    corpus = np.frombuffer((dictionary or b"") + data, np.uint8)
    base, mbs = len(dictionary or b""), clamp_block_size(case["block_size"])
    spans = [(lo, min(lo + mbs, len(corpus))) for lo in range(base, len(corpus), mbs)]
    per = device_pipeline.WINDOWS_PER_BATCH
    replays = {r["key"]: r for r in programs.replay_against_eager(
        dev, fn=matchfinder_torch.match_program)}
    rows = []
    for g in range(0, len(spans), per):
        corpus_dev, meta, W, k = matchfinder_torch.upload_batch(corpus, spans[g : g + per],
                                                                mbs, dev)
        bufs = matchfinder_torch.segments_from_corpus(corpus_dev, meta[: W * k],
                                                      matchfinder_torch.SEG_LEN)
        levels = suffix_torch.num_levels(bufs.shape[1])
        rank, distinct_at = bufs, None
        for level in range(levels):
            _, rank, distinct = suffix_torch._round(rank, 1 << level)
            if distinct_at is None and bool(distinct.all()):
                distinct_at = level + 1
        fresh = iter([suffix_torch.stored_rounds(bufs, 8)[0] for _ in range(3)])
        later_ms = programs._event_ms(lambda: suffix_torch.later_rounds(next(fresh), 8), 3)
        prog = replays[programs.program_key(matchfinder_torch.match_program, (corpus_dev, meta),
                                            {"W": W, "k": k})]
        if prog["max_abs_err"]:
            raise SystemExit(f"{case['name']}: the match program's replay differs from its "
                             "eager call")
        rows.append({"case": case["name"], "W": W, "k": k, "segments": W * k,
                     "distinct_after_round": distinct_at, "rounds": levels,
                     "rounds_past_8_ms": later_ms, "replay_ms": prog["replay_ms"],
                     "eager_ms": prog["eager_ms"], "capture_ms": prog["capture_ms"]})
        r = rows[-1]
        print(f"  match program [{case['name']}, W {W}, k {k}]: ranks distinct after round "
              f"{distinct_at} of {levels}; replay {r['replay_ms']:.3f} ms (rounds past 8 "
              f"{later_ms:.3f} ms, share {later_ms / r['replay_ms']:.3f}), eager "
              f"{r['eager_ms']:.3f} ms, capture {r['capture_ms']:.1f} ms")
    return rows


def _fresh(mode: str, data: bytes, case: dict, dev, smi: str) -> int:
    """The ``--fresh`` runs: what one process that compresses once pays."""
    torch.zeros(1, device=dev)  # the CUDA context, outside every timing
    if mode == "quicktest":
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            rc = cli.main(["-quicktest"], device=dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if rc != 0:
                raise SystemExit(f"cli -quicktest: exit code {rc}")
        print(f"fresh cli -quicktest: runs {', '.join(f'{t:.3f}' for t in secs)} s")
        print(json.dumps({"card": smi, "fresh": mode, "calls_s": secs}))
        return 0
    if mode == "one-shot":
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = device_pipeline.compress_device(data, case["flags"], case["block_size"],
                                                  device=dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if len(out) != case["out_len"]:
                raise SystemExit(f"output length {len(out)} != golden {case['out_len']}")
        print(f"fresh one-shot: calls {', '.join(f'{t:.3f}' for t in secs)} s")
        print(json.dumps({"card": smi, "fresh": mode, "calls_s": secs}))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.gz"
        src.write_bytes(data)
        t0 = time.perf_counter()
        rc = cli.main(["-gzip", "-c", str(src), str(dst)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = dst.read_bytes() if rc == 0 else b""
    size = len(out)
    if rc != 0 or zlib.decompress(out, 31) != data:
        raise SystemExit(f"cli: exit code {rc}, or its output does not decode to the input")
    print(f"fresh cli -gzip -c: {secs:.3f} s, {size} B")
    print(json.dumps({"card": smi, "fresh": mode, "seconds": secs, "out_bytes": size}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fresh", choices=("one-shot", "cli", "quicktest"),
                        help="time one process's first compressions alone")
    args = parser.parse_args()
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
    if args.fresh:
        return _fresh(args.fresh, data, case, dev, smi)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = device_pipeline.compress_device(data, case["flags"], case["block_size"],
                                              device=dev)
        torch.cuda.synchronize()
        if len(out) != case["out_len"]:
            raise SystemExit(f"output length {len(out)} != golden {case['out_len']}")
        return time.perf_counter() - t0

    first = run()  # the kernels' build, the allocator's caches; every shape eager
    second = run()  # every program's capture
    profiling.reset()  # the launch counts too
    profiling.enable()
    try:
        wall = run()
    finally:
        profiling.enable(False)
    report = profiling.report(reset=True)
    launches = report["launches"]
    reserved = torch.cuda.max_memory_reserved()
    print(f"first call: {first:.3f} s; second (captures): {second:.3f} s; untraced: "
          f"{wall:.3f} s, {len(data) / 1e6 / wall:.4f} MB/s; launches {launches}; peak "
          f"reserved {reserved} B")
    for name, sp in report["spans"].items():
        print(f"  span {name}: {sp['total_s']:.4f} s over {sp['calls']} calls")
    print(f"  counters {report['counters']}")
    progs = [{"key": p["text"], "name": p["key"][0].__qualname__, "capture_ms": p["capture_ms"],
              "launches": p["launches"]} for p in programs.captured(dev)]
    for p in progs:
        print(f"  program {p['key']}: capture {p['capture_ms']:.1f} ms; launches a replay "
              f"{p['launches']}")
    pool = programs.pool_bytes(dev)
    print(f"programs: {len(progs)} graphs, pool {pool} B")
    # Each program's device time: back-to-back replays on the inputs of its
    # last call (the untraced run's), beside an eager call's events.
    for p, r in zip(progs, programs.replay_against_eager(dev)):
        p.update(replay_ms=r["replay_ms"], eager_ms=r["eager_ms"], max_abs_err=r["max_abs_err"])
        if r["max_abs_err"]:
            raise SystemExit(f"program {p['key']}: replay differs from its eager call")
    for name in sorted({p["name"] for p in progs}):
        mine = [p for p in progs if p["name"] == name]
        print(f"  {name}: {len(mine)} graphs, replays {sum(p['replay_ms'] for p in mine):.3f} "
              f"ms of device time, eager calls {sum(p['eager_ms'] for p in mine):.3f} ms "
              f"(events); replay equal to eager")
    # What each program's replays launch, the port's kernels apart from
    # torch's own (the planner's and splitter's torch launches are the ops
    # around the kernels).
    replay_launches = _replay_launches(dev, list(launches))
    for name, r in sorted(replay_launches.items()):
        print(f"  {name}: one replay of each of its {r['graphs']} graphs launches {r['launches']}"
              f" ({r['device_ms']:.3f} ms device), of them torch's {r['torch_launches']} "
              f"({r['torch_device_ms']:.3f} ms)")
        for key, count in sorted(r["torch_by_name"].items(), key=lambda kv: -kv[1])[:12]:
            print(f"    {count:6d}x  {key}")

    runs = {"stage-timed": _staged(run, STAGES, eager=False),
            "eager stage-timed": _staged(run, STAGES + SUBSTAGES, eager=True)}
    for name, (secs, stages) in runs.items():
        print(f"{name}: {secs:.3f} s")
        for label, v in stages.items():
            print(f"  {label}: {v:.4f} s")

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
    print(f"traced: {traced:.3f} s wall, kernel time {sum(k[0] for k in kernels):.4f} s")
    for s, count, key in kernels[:15]:
        print(f"  {s:.4f} s  {count:7d}x  {key[:90]}")
    # A port kernel is ``{name}_kernel`` or, where one call makes several
    # launches, ``{name}_{phase}_kernel`` (the DP's spec, check, fixup),
    # or an instance of such a template (K12's, K14's network): one row a
    # name, its instances summed and listed beside.
    ours = {}
    for name in launches:
        for s, c, k in kernels:
            if m := re.search(rf"::({name}(?:_[a-z]+)?)_kernel(<[^>]*>)?\(", k):
                row = ours.setdefault(m.group(1), {"name": m.group(1), "s": 0.0, "count": 0,
                                                   "instances": []})
                row["s"] += s
                row["count"] += c
                row["instances"].append({"template": m.group(2) or "", "s": s, "count": c})
    ours = [dict(k, us_per_launch=k["s"] / k["count"] * 1e6) for k in ours.values()]
    for k in ours:
        split = "; ".join(f"{i['template']} {i['count']}x {i['s'] / i['count'] * 1e6:.2f} us"
                          for i in k["instances"]) if len(k["instances"]) > 1 else ""
        print(f"  port kernel {k['name']}: {k['s']:.6f} s over {k['count']} launches, "
              f"{k['us_per_launch']:.2f} us each" + (f" ({split})" if split else ""))
    # Every golden case's match programs, after the measurements above (its
    # captures add graphs to the pool).
    print("match programs of the golden cases:")
    golden_match = [row for c in json.loads(GOLDEN.read_text())["cases"]
                    for row in _golden_match(c, dev)]
    print(json.dumps({
        "card": smi, "golden_match": golden_match, "mb": len(data) / 1e6, "first_call_s": first, "second_call_s": second,
        "wall_s": wall, "spans": report["spans"], "counters": report["counters"],
        "mb_per_s": len(data) / 1e6 / wall, "launches": launches,
        "max_memory_reserved": reserved, "programs": progs,
        "pool_bytes": pool, "replay_launches": replay_launches,
        "stage_timed": {name: {"wall_s": secs, "stages_s": stages}
                        for name, (secs, stages) in runs.items()},
        "traced_wall_s": traced, "port_kernels": ours,
        "top_kernels": [{"s": s, "count": c, "name": k[:120]} for s, c, k in kernels[:15]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
