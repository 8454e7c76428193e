"""Smoke run of zultra_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from zultra_tpu_torch/csrc/ (one nvcc per source,
sm_90a), holds each kernel against its plain PyTorch version: the five
Pallas counterparts of the compression path (walk, DP, chain, MK, Kraft) at the shapes the
one-shot path gives them (the walk on the 128 segments of the 4 MiB
gzip case and on single segments of a zero run, a period-3 run, random
bytes and a partial core, with each launch's device time; the DP also
on every planner bucket of the 4 MiB gzip case, a 64 KiB zero run and a
2^21 lane, with the share of segments its fix-up re-ran; the chain on
the splitter's lanes, every planner bucket, a 64 KiB zero run and a 2^21
lane of 3s, with the share of segments it re-walked; MK and Kraft on the
splitter's and planner's batches, the path's own widths of 1, 4 and 84
lanes at 288, 32 and 19 symbols, a misaligned copy, edge lanes and the
launch floor, each with its device time per launch), and the two that
no path runs: matchlen on the match pairs of the 4 MiB corpus (with
their length distribution), a seeded edge batch and
``matchlen_cuda.edge_pairs`` at every base offset 0-15; the byte
histogram on the 4 MiB corpus, an unaligned view, 64 MiB of seeded
bytes and 64 MiB of one value, beside ``torch.bincount``; and the three
kernels of the planner's and splitter's scans at the shapes the 4 MiB
gzip run gives them: the RLE decision sweep (the planner's pair call,
both histogram sets in one launch, at every lane count of the run, and
each set alone), the RLE statistics (every shape the run called, from
the code lengths themselves: the mask search's 20 masks in one launch a
mode, the one-mask calls of the dynamic costs; the histograms also
with their bins summed the other way; beside the launch floor) and the
prefix tables (4 x 2^21 tokens and a seeded lane of one 64 KiB window,
with each of a call's three launches, beside ``torch.cumsum`` of their
one-hot), each with its bound over the run; and the four kernels of the planner's
fused passes (``csrc/plan.cu``) at the shapes the 4 MiB gzip run gives
them: the DP's lane preparation and the emission on every planner
bucket (the emission also on a lane of length 0, a lane of literals
alone and a lane cut to no multiple of its tile, with the device time
of the memset of its words beside the kernel's, and of a
``torch.zeros`` of the same words), the token histograms
on every bucket with the splitter's marks (the match tables' first row,
a strided view) and with the chain's, and
on a zero-run lane and a one-byte lane (``plan_cuda.hammer_lanes``), and
the (key, index) order of every row shape the planner and the splitter
sort, of rows of one repeated key and of rows of 1024 keys, beside
``torch.sort(stable=True)``. Then
compresses every case of zultra_tpu_torch/smoke_golden.json in one
shot: a seeded 4 MiB mixed corpus in gzip (four 1 MiB windows in one
device batch), then deflate, zlib at 64 KiB blocks, a preset
dictionary, incompressible bytes and 2 MiB at 64 KiB blocks (33
windows, three device batches). The match stage, the planner and the
splitter run as programs (``ops/programs.py``: a shape's first call runs
eagerly, its second is captured into a CUDA graph and replayed, later
ones replay);
the programs phase replays each one captured so far against an eager
call of its function on the same inputs (every output equal, no sync
inside the replay), checks that the gzip run that captured launched what
its eager first run launched and captured the programs of that run's
shapes and no other (its match program among them), and that a replaying
gzip run launched the same, and prints each program's launches, capture
and replay ms (the gzip run's match program on a line of its own), the
graph pool's bytes and the number of graphs. Then streams
the gzip and the 33-window cases through ``Stream`` in 16 KiB chunks, and
runs the CLI (``-c``, ``-cbench``, ``-quicktest``). Then the paths of many
windows, devices and processes: every window of the zlib case planned
alone (``DeviceWindowEngine.begin_window`` + ``emit_window``), the
33-window case at ``windows_per_batch`` 2 and 5, the gzip case over a
``devices`` list (every card torch sees, or ``cuda:0`` twice), the gzip
case in windows mode across 2 spawned gloo ranks on ``cuda:0``
(``parallel.multihost.run_windows_distributed``), corpus statistics of the
4 MiB corpus (``parallel.sharded_corpus_stats``: suffix arrays, the byte
histogram kernel, Adler partial sums) with the checksums against zlib, and
``ops.emit_torch.write_tokens`` on one block of the gzip case's plan. Then
the sharded phase: the staircase match finder on the gzip case's segments
at 64 KiB cores (equal to the walk kernel's rows on every segment that does
not overflow and to its own CPU run on two segments; ms a segment against
the walk's), ``parallel.compress_sharded`` on the gzip and dictionary cases
over ``["cuda:0"]`` and ``["cuda:0", "cuda:0"]`` (a first call and a
replay each) and on a zero-heavy input whose segments overflow (equal to
``compress_device``'s bytes), ``ops.optimize_matches`` on a 1 MiB block
against its CPU run, the phase's peak memory reserved, the graphs held
after it, and a gzip one-shot run that must replay its graphs. Each
compression must
rebuild the recorded input (sha256), match the recorded output digest
(what zultra_tpu writes on its native engine), decode with zlib, and
launch all twelve compression kernels, counted from 0 just before each run
(the statistics phase the histogram kernel, ``write_tokens`` the chain
kernel; the ranks of the distributed run report their own counts; a
sharded compression the eleven planner and splitter kernels, and the walk
where a segment overflowed). Prints
the card's name and power limit, one line per phase, a JSON line of
kernel results and, last, {"ok": true, "device": {...}}. Exits non-zero
on any failure, and before printing any result when no CUDA device is
present. Imports nothing of zultra_tpu.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
GOLDEN = Path(__file__).resolve().parent / "zultra_tpu_torch" / "smoke_golden.json"
# name -> (source, TPU kernel it replaces)
KERNELS = {
    "walk": ("zultra_tpu_torch/csrc/walk.cu", "zultra_tpu/ops/walk_pallas.py:78"),
    "dp": ("zultra_tpu_torch/csrc/dp.cu", "zultra_tpu/ops/dp_pallas.py:69"),
    "chain": ("zultra_tpu_torch/csrc/chain.cu", "zultra_tpu/ops/chain_pallas.py:41"),
    "mk12": ("zultra_tpu_torch/csrc/mk.cu", "zultra_tpu/ops/mk_pallas.py:62"),
    "kraft": ("zultra_tpu_torch/csrc/mk.cu", "zultra_tpu/ops/mk_pallas.py:153"),
    "hist": ("zultra_tpu_torch/csrc/histogram.cu", "zultra_tpu/ops/histogram.py:31"),
    # No Pallas counterpart: these replace XLA programs of the planner and
    # splitter (a lax.scan, the RLE statistics, jnp.cumsum).
    "rle_sweep": ("zultra_tpu_torch/csrc/rle.cu", "zultra_tpu/ops/entropy_jax.py:462"),
    "rle_stats": ("zultra_tpu_torch/csrc/rle.cu", "zultra_tpu/ops/entropy_jax.py:255"),
    "prefix_tables": ("zultra_tpu_torch/csrc/prefix.cu", "zultra_tpu/ops/split_jax.py:176"),
    # The planner's fused XLA passes (no Pallas counterpart either): the DP's
    # lane preparation, token histograms, token emission and the (key,
    # index) sort of short rows.
    "prep_lanes": ("zultra_tpu_torch/csrc/plan.cu", "zultra_tpu/ops/dp_pallas.py:192"),
    "token_hist": ("zultra_tpu_torch/csrc/plan.cu", "zultra_tpu/ops/block_jax.py:170"),
    "emit_tokens": ("zultra_tpu_torch/csrc/plan.cu", "zultra_tpu/ops/block_jax.py:331"),
    "lex_order": ("zultra_tpu_torch/csrc/plan.cu", "zultra_tpu/ops/entropy_jax.py:77"),
    # The suffix doubling's round (the JAX package's lax.sort round; no
    # Pallas counterpart).
    "suffix_round": ("zultra_tpu_torch/csrc/suffix.cu", "zultra_tpu/ops/suffix_jax.py:82"),
}
COMPRESS_KERNELS = ("walk", "dp", "chain", "mk12", "kraft", "rle_sweep", "rle_stats",
                    "prefix_tables", "prep_lanes", "token_hist", "emit_tokens",
                    "lex_order", "suffix_round")  # every compression's path
# The kernel that no path of either package runs (tests and exports only).
OFF_PATH_KERNELS = {
    "matchlen": ("zultra_tpu_torch/csrc/matchlen.cu", "zultra_tpu/ops/matchlen.py:34"),
}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_ms(fn) -> tuple:
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bytes_ms(n: int) -> float:
    """Milliseconds to move n bytes at the card's memory rate."""
    return n / HBM_BYTES_PER_S * 1e3


def bound_ms(*tensors) -> float:
    """Least time to read every input and write every output once at the
    card's memory rate (the kernels do no tensor-core work)."""
    return bytes_ms(nbytes(*tensors))


def launch_device_ms(fn, kernel: str, reps: int) -> dict:
    """{kernel name: mean device ms a launch} of the CUDA kernels
    ``{kernel}_{phase}_kernel`` over ``reps`` calls of ``fn`` (a
    torch.profiler trace after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = {}
    for ev in prof.key_averages():
        m = re.search(rf"::({kernel}_[a-z]+_kernel)", ev.key)
        if m and ev.count:
            found[m.group(1)] = ev.self_device_time_total / ev.count / 1e3
    return found


def zeroing_device_ms(fn, reps: int = 20):
    """Mean device ms a call of the zeroing in ``fn``: its memsets or
    torch's fill kernels (a torch.profiler trace of ``reps`` calls after
    one warm-up call). A trace may drop device events: one that recorded
    fewer zeroings than calls is taken again, up to five times, and the
    last one that recorded any is averaged over the zeroings it holds;
    None when no trace holds one."""
    from torch.profiler import ProfilerActivity, profile

    got = None
    for _ in range(5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.count and ev.self_device_time_total
               and ("memset" in ev.key.lower() or "FillFunctor" in ev.key)]
        us = sum(ev.self_device_time_total for ev in evs)
        count = sum(ev.count for ev in evs)
        if count >= reps:
            return us / reps / 1e3
        if count:
            got = us / count / 1e3
    return got


def emit_edge_calls(buckets: dict) -> dict:
    """{label: emission args} at the edges of its tiling, cut from the
    run's own calls ({shape: args}): a lane of length 0 (no mark) at the
    128-lane bucket's width, a lane of literals alone at the one-lane
    bucket's, and the one-lane bucket cut to 100003 positions (a multiple
    neither of a tile nor of 8: the byte-wise loads)."""
    wide = buckets[max(buckets)]
    one = next(args for (B, _), args in buckets.items() if B == 1)
    lane0 = tuple(a[:1].contiguous() for a in wide)
    zero = torch.zeros_like(one[1])
    cut = 100003
    return {
        f"length-0 lane {tuple(lane0[0].shape)}": (*lane0[:7], torch.zeros_like(lane0[7])),
        f"literals alone {tuple(one[0].shape)}": (one[0], zero, zero, *one[3:7],
                                                   torch.ones_like(one[7])),
        f"cut lane (1, {cut})": tuple(a[:, :cut].contiguous() if a.shape[1] > cut else a
                                      for a in one),
    }


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    torch.cuda.synchronize()
    got = got.cpu().to(torch.int64)
    want = want.cpu().to(torch.int64)
    if got.shape != want.shape:
        raise SystemExit(f"{name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    if err != 0:
        raise SystemExit(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def check_output(name: str, case: dict, data: bytes, dictionary, out: bytes) -> None:
    """Raise unless ``out`` equals the case's golden digest and zlib
    decodes it to ``data``."""
    if len(out) != case["out_len"] or sha256(out) != case["out_sha256"]:
        raise SystemExit(f"{name}: port output ({len(out)} B) differs from the golden "
                         f"digest ({case['out_len']} B)")
    wbits = {0: -15, 1: 15, 2: 31}[case["flags"]]
    dec = (zlib.decompressobj(wbits, zdict=dictionary) if dictionary
           else zlib.decompressobj(wbits))
    if dec.decompress(out) + dec.flush() != data:
        raise SystemExit(f"{name}: zlib does not decode the port's output to the input")


def path_counts(name: str, counts: dict, kernels=COMPRESS_KERNELS) -> dict:
    """The path kernels' launches of one run; raise if one is 0."""
    got = {k: counts[k] for k in kernels}
    for k, c in got.items():
        if c <= 0:
            raise SystemExit(f"{name}: the run launched no {k} kernel")
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to smoke-test", file=sys.stderr)
        return 2
    from zultra_tpu_torch import (
        FINALIZE,
        DeviceWindowEngine,
        Stream,
        _build,
        chain_bench,
        cli,
        compress_device,
        frame,
        matchlen_hist_bench,
        suffix_bench,
        walk_bench,
    )
    from zultra_tpu_torch.corpus import case_inputs, text_corpus
    from zultra_tpu_torch.matchlen_hist_bench import trace_ms as device_ms
    from zultra_tpu_torch.ops import (
        block_torch,
        chain_cuda,
        dp_cuda,
        entropy_torch,
        histogram_cuda,
        launch_counts,
        matchlen_cuda,
        mk_cuda,
        plan_cuda,
        prefix_cuda,
        programs,
        reset_launch_counts,
        rle_cuda,
        split_torch,
        suffix_cuda,
        suffix_torch,
        walk_cuda,
    )
    from zultra_tpu_torch.ops.entropy_torch import (
        build_lengths,
        kraft_inputs,
        mask_histograms,
        mk_inputs,
        mk_lengths,
    )
    from zultra_tpu_torch.ops import checksum, matchfinder_torch
    from zultra_tpu_torch.ops.emit_torch import write_tokens
    from zultra_tpu_torch.ops.matchfinder_torch import HALO, match_tables_device_stacked
    from zultra_tpu_torch.parallel import multihost, sharded_corpus_stats
    from zultra_tpu_torch.stream import clamp_block_size, memory_bound

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"card: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for src in ("walk", "dp", "chain", "mk", "matchlen", "histogram", "rle", "prefix", "plan"):
        for line in _build.build_log.get(src, "").splitlines():
            if line.strip():
                print(f"nvcc -Xptxas -v {src}.cu: {line.strip()}")

    # -- the golden cases' inputs ------------------------------------------
    golden = json.loads(GOLDEN.read_text())["cases"]
    inputs = {}
    for case in golden:
        data, dictionary = case_inputs(case)
        if sha256(data) != case["input_sha256"]:
            raise SystemExit(f"{case['name']}: the rebuilt input differs from the recorded one "
                             "(numpy's generator on this machine), not a fault of the port")
        inputs[case["name"]] = (data, dictionary)
    data = inputs["gzip"][0]

    # -- each kernel against its plain version -----------------------------
    corpus = np.frombuffer(data, np.uint8)
    mbs = 1 << 20
    spans = [(lo, min(lo + mbs, len(data))) for lo in range(0, len(data), mbs)]
    results = {}

    lens, offs = match_tables_device_stacked(corpus, spans, mbs, dev)

    # DP: four inputs, each against the sequential plain form on the host
    # and with the share of segments the kernel's fix-up re-ran. Eight
    # 32 KiB corpus lanes (the row kept from the first kernel), the lanes
    # of every planner bucket of the 4 MiB gzip case (its first pass), one
    # lane that is a 64 KiB zero run (no segment anchors), and two lanes
    # of 2^21 positions (a 2 MiB block, the longest), text and random
    # bytes.
    def dp_row(label, args, reps):
        got, st = dp_cuda.dp_choices(*args, status=True)
        want, plain = host_ms(lambda: dp_cuda.dp_choices_plain(*[a.cpu() for a in args[:4]]))
        seg = st[st != dp_cuda.ST_NONE]
        n_rerun = int((seg == dp_cuda.ST_RERUN).sum())
        row = dict(batch=label, shape=list(args[0].shape), lengths=args[4].tolist()[:16],
                   max_abs_err=compare(f"dp [{label}]", got, want), plain_ms=plain,
                   ms=cuda_ms(lambda: dp_cuda.dp_choices(*args), reps),
                   bound_ms=bound_ms(*args, got), segments=int(seg.numel()), rerun=n_rerun,
                   fixed_share=n_rerun / max(1, int(seg.numel())))
        print(f"dp [{label}]: equal on {tuple(args[0].shape)} lanes x positions; kernel "
              f"{row['ms']:.4f} ms (3 launches), plain {plain:.1f} ms (cpu), bound "
              f"{row['bound_ms']:.4g} ms; segments {row['segments']}, re-run {n_rerun} "
              f"(share {row['fixed_share']:.4f})")
        return row

    def one_lane(buf):
        n_l = len(buf)
        l_lens, l_offs = match_tables_device_stacked(buf, [(0, n_l)], n_l, dev)
        w_l = torch.from_numpy(buf.copy()).to(dev)[None]
        ml_l = l_lens[:, HALO : HALO + n_l].contiguous()
        mo_l = l_offs[:, HALO : HALO + n_l].contiguous()
        ln = torch.full((1,), n_l, dtype=torch.int32, device=dev)
        gl, go, _ = block_torch.token_hist(w_l, ml_l[:, :, 0], mo_l[:, :, 0], ln)
        return (*dp_cuda.prep_lanes(build_lengths(gl, 15), build_lengths(go, 15), w_l, ml_l,
                                    mo_l, ln), ln)

    n = 32768
    W = len(spans)
    lanes = [(w, HALO + j * n) for w in range(W) for j in range(2)][:8]
    win = torch.stack([torch.from_numpy(corpus[spans[w][0] + s - HALO:][:n].copy())
                       for w, s in lanes]).to(dev)
    ml = torch.stack([lens[w, s : s + n] for w, s in lanes]).contiguous()
    mo = torch.stack([offs[w, s : s + n] for w, s in lanes]).contiguous()
    length = torch.full((len(lanes),), n, dtype=torch.int32, device=dev)
    g_lit, g_off, _ = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    dp_rows = [dp_row("8 x 32768 corpus lanes", (*dp_cuda.prep_lanes(
        build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo, length), length), 3)]

    real_run_dp = block_torch.run_dp
    buckets = {}  # n_pad -> the planner's DP arguments of its first pass
    real_token_hist, real_emit = block_torch.token_hist, block_torch.emit_tokens
    emitted = {}  # the first planner bucket's lane lengths, emission arguments and result
    # The scans' arguments of the run, by shape: the sweep's histograms, the
    # RLE statistics' calls (mode, lanes, masks), the splitter's tokens.
    real_sweep = block_torch.optimize_for_rle_pair
    real_hist, real_bits = entropy_torch.rle_histogram_tables, entropy_torch.rle_bits_tables
    real_prefix = split_torch.prefix_tables
    scan_args = {"rle_sweep": {}, "rle_stats": {}, "prefix_tables": {}}
    # The fused passes' arguments of the run, by shape: the token histograms
    # (with the marks each call used), the emissions, the short-row sorts.
    real_lex = entropy_torch._lex_order
    fused_args = {"token_hist": {}, "emit_tokens": {}, "lex_order": {}}
    # And how often the run calls the histograms and the sorts at each
    # shape (a program's eager first call launches what its replays do):
    # each shape's bound times its calls, summed, is the bound over the run.
    fused_calls = {"token_hist": {}, "lex_order": {}, "rle_stats": {}, "prefix_tables": {},
                   "rle_sweep": {}, "emit_tokens": {}}

    # The planner and the splitter are programs (ops/programs.py): the
    # first call of each shape runs eagerly, the second is captured into a
    # CUDA graph. The wrappers record on that eager call alone: a
    # capture's tensors hold nothing until a replay, and a copy made inside
    # a capture would join the graph. They wrap functions the programs
    # call, never a program's own function, whose identity keys it.
    def record(table, key, make):
        if key not in table and not torch.cuda.is_current_stream_capturing():
            table[key] = make()

    def count(table, key):
        if not torch.cuda.is_current_stream_capturing():
            table[key] = table.get(key, 0) + 1

    def recording_sweep(lit, off):
        key = (lit.shape[0], lit.shape[1], off.shape[1])
        record(scan_args["rle_sweep"], key, lambda: (lit.clone(), off.clone()))
        count(fused_calls["rle_sweep"], key)
        return real_sweep(lit, off)

    def recording_hist(lit, off, masks):
        key = ("histogram", lit.shape[0], len(masks))
        record(scan_args["rle_stats"], key, lambda: (lit.clone(), off.clone(), tuple(masks)))
        count(fused_calls["rle_stats"], key)
        return real_hist(lit, off, masks)

    def recording_bits(lit, off, te, masks):
        key = ("bits", lit.shape[0], len(masks))
        record(scan_args["rle_stats"], key,
               lambda: (lit.clone(), off.clone(), te.clone(), tuple(masks)))
        count(fused_calls["rle_stats"], key)
        return real_bits(lit, off, te, masks)

    def recording_prefix(*args):
        record(scan_args["prefix_tables"], tuple(args[0].shape),
               lambda: tuple(a.clone() for a in args))
        count(fused_calls["prefix_tables"], tuple(args[0].shape))
        return real_prefix(*args)

    def recording_run_dp(*args):
        record(buckets, args[2].shape[1], lambda: args)
        return real_run_dp(*args)

    def recording_token_hist(window, lens, offs, length, is_tok=None):
        record(emitted, "length", length.clone)  # the planner's first call: its lane lengths
        out = real_token_hist(window, lens, offs, length, is_tok)
        key = (tuple(window.shape), is_tok is not None)
        record(fused_args["token_hist"], key, lambda: (window, lens, offs, out[2]))  # views
        count(fused_calls["token_hist"], key)
        return out

    def recording_emit(*args):
        out = real_emit(*args)
        record(emitted, "args", lambda: args)
        record(emitted, "out", lambda: out)
        record(fused_args["emit_tokens"], tuple(args[0].shape), lambda: args)
        count(fused_calls["emit_tokens"], tuple(args[0].shape))
        return out

    def recording_lex(key):
        record(fused_args["lex_order"], tuple(key.shape), key.clone)
        count(fused_calls["lex_order"], tuple(key.shape))
        return real_lex(key)

    block_torch.run_dp = recording_run_dp
    block_torch.token_hist, block_torch.emit_tokens = recording_token_hist, recording_emit
    block_torch.optimize_for_rle_pair = recording_sweep
    entropy_torch.rle_histogram_tables, entropy_torch.rle_bits_tables = recording_hist, recording_bits
    split_torch.prefix_tables = recording_prefix
    entropy_torch._lex_order = recording_lex
    try:
        # Also the warm-up of the library and caches, and the first call of
        # each of the gzip run's programs: eager.
        # The gzip run's keys: those it met first, and the match program's,
        # which the call above met first and this run captured.
        seen_before = set(programs.device_programs(dev).seen)
        captured_before = {p["key"] for p in programs.captured(dev)}
        reset_launch_counts()
        compress_device(data, 2, device=dev)
        eager_counts = launch_counts()
        gzip_keys = ((set(programs.device_programs(dev).seen) - seen_before)
                     | ({p["key"] for p in programs.captured(dev)} - captured_before))
    finally:
        block_torch.run_dp = real_run_dp
        block_torch.token_hist, block_torch.emit_tokens = real_token_hist, real_emit
        block_torch.optimize_for_rle_pair = real_sweep
        entropy_torch.rle_histogram_tables, entropy_torch.rle_bits_tables = real_hist, real_bits
        split_torch.prefix_tables = real_prefix
        entropy_torch._lex_order = real_lex
    for n_pad, args in sorted(buckets.items()):
        dp_rows.append(dp_row(f"gzip bucket {n_pad}", (*dp_cuda.prep_lanes(*args), args[5]), 3))
    dp_rows.append(dp_row("64 KiB zero run", one_lane(np.zeros(1 << 16, np.uint8)), 3))
    dp_rows.append(dp_row("2^21 text", one_lane(
        np.frombuffer(text_corpus(1 << 21, 6), np.uint8)), 1))
    dp_rows.append(dp_row("2^21 random bytes", one_lane(
        np.random.default_rng(6).integers(0, 256, 1 << 21, np.uint8)), 1))
    results["dp"] = dict(dp_rows[0], plain_device="cpu", rows=dp_rows)

    # Chain: the lanes of chain_bench (the splitter's four 2^21 lanes, every
    # planner bucket of the 4 MiB gzip case's first pass, a 2^21 lane of 3s,
    # where two thirds of the segments cannot merge, and a 64 KiB zero
    # run), each against pointer doubling on the host, with the segments
    # the kernel anchored, re-walked (merging) and left unmerged. Output:
    # one byte a position.
    def chain_row(label, args, reps):
        got, st = chain_cuda.chain_marks(*args, status=True)
        want, plain = host_ms(lambda: chain_cuda.chain_marks_plain(*[a.cpu() for a in args]))
        live = st[st != chain_cuda.ST_NONE]
        counts = {k: int((live == getattr(chain_cuda, f"ST_{k.upper()}")).sum())
                  for k in ("exact", "anchored", "rerun", "unmerged")}
        walked = counts["rerun"] + counts["unmerged"]
        row = dict(batch=label, shape=list(args[0].shape), lengths=args[2].tolist()[:16],
                   max_abs_err=compare(f"chain [{label}]", got, want), plain_ms=plain,
                   ms=cuda_ms(lambda: chain_cuda.chain_marks(*args), reps),
                   device_ms=device_ms(lambda: chain_cuda.chain_marks(*args), "chain", reps),
                   bound_ms=bound_ms(*args, got), segments=int(live.numel()), **counts,
                   rewalk_share=walked / max(1, int(live.numel()) - counts["exact"]))
        print(f"chain [{label}]: equal on {tuple(args[0].shape)} lanes x positions; kernel "
              f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}, 2 launches), plain "
              f"{plain:.1f} ms (cpu), bound {row['bound_ms']:.4g} ms; segments "
              f"{row['segments']}: exact {counts['exact']}, anchored {counts['anchored']}, "
              f"re-run {counts['rerun']}, unmerged {counts['unmerged']} (share re-walked "
              f"{row['rewalk_share']:.4f})")
        return row

    chain_rows = [chain_row(label, args, 3) for label, args in chain_bench.lanes(dev).items()]
    results["chain"] = dict(chain_rows[0], plain_device="cpu", rows=chain_rows)

    # Walk: walk_bench's segments (the main path's call on the 128 segments
    # of the gzip case, one zero run, one period-3 run, one of random bytes,
    # one partial core), each against the plain walk on the host, with the
    # device time of each of its three launches (sweep, park, chunk walk).
    # It comes after the chain: with a profiler trace taken ahead of the
    # compressions above, the chain's traces recorded none of its kernels.
    walk_rows = []
    for label, (salcp, halo, core) in walk_bench.segments(dev).items():
        S, n = salcp.shape

        def walk_call():
            return walk_cuda.walk_segments(salcp, halo, core)

        got = walk_call()
        want, plain = host_ms(lambda: walk_cuda.walk_segments_plain(salcp.cpu(), halo, core))
        row = dict(batch=label, shape=[S, n], core_len=core,
                   max_abs_err=compare(f"walk [{label}]", got, want), plain_ms=plain,
                   ms=cuda_ms(walk_call, 3), device_ms=walk_bench.kernel_ms(walk_call, 3),
                   chunk=walk_cuda.CHUNK, scratch_bytes=walk_cuda.scratch_bytes(S, n, core),
                   bound_ms=bound_ms(salcp, got))
        per_launch = ", ".join(f"{k.removeprefix('walk_').removesuffix('_kernel')} {v:.4f}"
                               for k, v in row["device_ms"].items())
        print(f"walk [{label}]: equal on {S} x {n} words, core {core}; kernel {row['ms']:.4f} ms "
              f"(device ms per launch: {per_launch}), plain {plain:.1f} ms (cpu), bound "
              f"{row['bound_ms']:.4g} ms; chunk {row['chunk']}, scratch {row['scratch_bytes']} B")
        walk_rows.append(row)
    results["walk"] = dict(walk_rows[0], plain_device="cpu", rows=walk_rows)

    # The doubling round: a 16-window batch of 1 MiB mixed windows (512
    # segments of 65,794, the main path's) and one of 2 MiB text windows
    # (1024), cut as the match program cuts them. The kernel's 17 rounds
    # (8 stored) against the plain rounds on the card: the suffix order,
    # the stored ranks, the rounds each segment ran. By events: the first
    # round alone (it also sorts the symbols), each later round of the
    # doubling (those that run and those every segment skips), a skip in
    # place and a skip that copies its ranks (a stored level); beside them
    # the plain round (plain_ms) and torch.sort of one round's packed keys
    # (library_ms); the port calls neither on these rows.
    def doubling_row(label, content, windows, block):
        bufs = suffix_bench.batch(content, windows, block, dev)
        S, n = bufs.shape
        levels = suffix_torch.num_levels(n)
        got = suffix_bench.kernel_rounds(bufs)
        sa_p, ranks_p, flags = suffix_bench.plain_rounds(bufs)
        flags = torch.stack(flags)
        first = torch.where(flags.any(0), flags.to(torch.int32).argmax(0) + 1, levels)
        err = max(compare(f"doubling_round [{label}] sa", got[0], sa_p),
                  compare(f"doubling_round [{label}] ranks", got[1], ranks_p),
                  compare(f"doubling_round [{label}] rounds run", got[2], first))
        per_round = suffix_bench.per_round_ms(suffix_bench.kernel_rounds, bufs, levels)
        ran = int(got[2].max())
        state = suffix_cuda.new_state(S, n, dev)
        symbols, out = bufs.to(torch.int32), torch.empty_like(ranks_p[0])
        done, _ = suffix_torch.stored_rounds(bufs, 8)
        done = suffix_torch.later_rounds(done, 8)
        copy_to = torch.empty_like(done.rank)
        keys = ranks_p[1].to(torch.int64) * (n + 257) + 1
        row = dict(batch=label, shape=[S, n], max_abs_err=err, rounds=levels, rounds_run=ran,
                   ms=cuda_ms(lambda: suffix_cuda.launch_round(symbols, out, state, 1, True), 3),
                   round_ms=per_round, run_round_ms=statistics.mean(per_round[1:ran]),
                   skip_ms=cuda_ms(lambda: suffix_cuda.launch_round(
                       done.rank, done.rank, done.state, 1 << (levels - 1), False), 5),
                   skip_copy_ms=cuda_ms(lambda: suffix_cuda.launch_round(
                       done.rank, copy_to, done.state, 1 << 7, False), 5),
                   plain_ms=cuda_ms(lambda: suffix_torch._round(ranks_p[1], 2), 3),
                   library_ms=cuda_ms(lambda: torch.sort(keys, dim=1, stable=True), 3),
                   bound_ms=bytes_ms(16 * S * n))
        print(f"doubling_round [{label}]: equal on {S} x {n} (suffix order, 9 stored rank tables, "
              f"rounds run: at most {ran} of {levels}); first round {row['ms']:.4f} ms, later "
              f"rounds that run {row['run_round_ms']:.4f} ms each, a skipped round "
              f"{row['skip_ms']:.4f} ms ({row['skip_copy_ms']:.4f} ms with its copy), plain "
              f"round {row['plain_ms']:.4f} ms (cuda), torch.sort of its keys "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms; each round: "
              + " ".join(f"{v:.3f}" for v in per_round))
        return row

    suffix_rows = [doubling_row(*shape) for shape in suffix_bench.SHAPES[:2]]
    torch.cuda.empty_cache()
    results["suffix_round"] = dict(suffix_rows[0], plain_device="cuda", rows=suffix_rows)

    # MK and Kraft at the main path's shapes. Histograms are the greedy
    # token histograms of the corpus cut into lanes: 4096 lanes of 1 KiB
    # (the splitter's batch for four 1 MiB windows: 4 x 2 x trig_cap 512),
    # 40 lanes of 64 KiB (the first kernel's planner row; 40 is no multiple
    # of 32), and the planner's own batch widths, 1, 4 and 84 lanes (of
    # 32 KiB), at S = 288, 32 and the CL alphabet's 19. Then a misaligned
    # copy of a batch in each MK layout (a base 4 bytes past a 16-byte
    # boundary), edge lanes (all weights equal, n_used 0, 1, 2, 3 and S) in
    # each MK layout, and the launch floor: one lane of 2 symbols. Each row is
    # held exactly against its plain form, with ms by events and the
    # device ms of a launch from a trace.
    def lane_hists(n_lanes, lane_len):
        lw = torch.from_numpy(corpus[: n_lanes * lane_len].copy()).to(dev).view(n_lanes, lane_len)
        lr = lens[:, HALO:, 0].reshape(-1, lane_len)[:n_lanes].contiguous()
        lo = offs[:, HALO:, 0].reshape(-1, lane_len)[:n_lanes].contiguous()
        ln = torch.full((n_lanes,), lane_len, dtype=torch.int32, device=dev)
        return block_torch.token_hist(lw, lr, lo, ln)[:2]

    def edge_hists(B, S):
        erng = np.random.default_rng(S)
        h = np.zeros((B, S), np.int32)
        for b in range(B):
            kind = b % 6
            if kind == 0:
                h[b] = 9
            else:
                used = (0, 1, 2, 3, S)[kind - 1]
                h[b, erng.permutation(S)[:used]] = erng.integers(1, 1000, used)
        return torch.from_numpy(h).to(dev)

    def misaligned(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
        return buf.view(x.shape).copy_(x)

    split_lit, split_off = lane_hists(4096, 1024)
    plan_lit, plan_off = lane_hists(40, 65536)
    cl_hists = mask_histograms(build_lengths(plan_lit, 15), build_lengths(plan_off, 15))[0]
    small_lit, small_off = lane_hists(84, 32768)
    small_cl = mask_histograms(build_lengths(small_lit, 15), build_lengths(small_off, 15))[0]
    rng = np.random.default_rng(0)
    skewed = torch.from_numpy((2 ** rng.integers(0, 21, (4096, 288))).astype(np.int32)).to(dev)

    def shape_row(name, kernel, plain_fn, args, **extra):
        got = kernel(*args)
        want = plain_fn(*args)
        B = args[0].shape[0]
        row = dict(shape=list(args[0].shape), max_abs_err=compare(f"{name} {extra}", got, want),
                   ms=cuda_ms(lambda: kernel(*args), 20),
                   device_ms=device_ms(lambda: kernel(*args), name, 20),
                   plain_ms=cuda_ms(lambda: plain_fn(*args), 1),
                   bound_ms=bound_ms(*[a for a in args if torch.is_tensor(a)], got),
                   layout=("thread per lane" if name == "mk12" and B > mk_cuda.WARP_LANES
                           else "warp per lane"), **extra)
        print(f"{name} [{', '.join(f'{k} {v}' for k, v in extra.items())}]: equal on "
              f"{tuple(args[0].shape)} ({row['layout']}, base mod 16 = {args[0].data_ptr() % 16});"
              f" kernel {row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}), plain "
              f"{row['plain_ms']:.2f} ms (cuda), bound {row['bound_ms']:.3g} ms")
        return row

    def mk_row(label, h, misalign=False):
        a0, n_used, _ = mk_inputs(h)
        if misalign:
            a0 = misaligned(a0)
        return shape_row("mk12", mk_cuda.mk_phase12, mk_cuda.mk_phase12_plain, (a0, n_used),
                         batch=label)

    def kraft_row(label, h, max_len, misalign=False):
        lens_in, n_used, kraft0, _, _ = kraft_inputs(mk_lengths(h), max_len)
        if misalign:
            lens_in = misaligned(lens_in)
        return shape_row(
            "kraft", lambda *a: mk_cuda.kraft_limit(*a, max_len),
            lambda *a: mk_cuda.kraft_limit_plain(*a, max_len), (lens_in, n_used, kraft0),
            batch=label, max_len=max_len,
            repair_lanes=int((kraft0 > (1 << max_len)).sum()),
            fit_lanes=int((kraft0 == (1 << max_len)).sum()))

    mk_rows = [mk_row(label, h) for label, h in (
        ("splitter 288", split_lit), ("splitter 32", split_off), ("planner 288", plan_lit),
        ("planner 32", plan_off), ("mask search 19", cl_hists))]
    kraft_rows = [kraft_row(label, h, max_len) for label, h, max_len in (
        ("planner 288", plan_lit, 15), ("planner 32", plan_off, 15),
        ("mask search 19", cl_hists, 7), ("skewed 288", skewed, 15))]
    if kraft_rows[-1]["repair_lanes"] == 0:
        raise SystemExit("kraft: the skewed batch has no lane that needs the repair")
    for B in (1, 4, 84):
        for S, h, max_len in ((288, small_lit, 15), (32, small_off, 15), (19, small_cl, 7)):
            mk_rows.append(mk_row(f"path {B} x {S}", h[:B]))
            kraft_rows.append(kraft_row(f"path {B} x {S}", h[:B], max_len))
    for label, h in (("misaligned splitter 288", split_lit), ("misaligned 84 x 288", small_lit)):
        mk_rows.append(mk_row(label, h, misalign=True))
    for label, h in (("misaligned skewed 288", skewed), ("misaligned 84 x 288", small_lit)):
        kraft_rows.append(kraft_row(label, h, 15, misalign=True))
    for S in (19, 32, 288):
        for B in (6, 600):
            mk_rows.append(mk_row(f"edge lanes {B} x {S}", edge_hists(B, S)))
            for max_len in (7, 15):
                kraft_rows.append(kraft_row(f"edge lanes {B} x {S}", edge_hists(B, S), max_len))
    floor_args = (torch.ones((1, 2), dtype=torch.int32, device=dev),
                  torch.full((1,), 2, dtype=torch.int32, device=dev))
    mk_rows.append(shape_row("mk12", mk_cuda.mk_phase12, mk_cuda.mk_phase12_plain, floor_args,
                             batch="launch floor 1 x 2"))
    kraft_rows.append(shape_row(
        "kraft", lambda *a: mk_cuda.kraft_limit(*a, 15),
        lambda *a: mk_cuda.kraft_limit_plain(*a, 15),
        (*floor_args, torch.full((1,), 1 << 15, dtype=torch.int32, device=dev)),
        batch="launch floor 1 x 2", max_len=15))
    results["mk12"] = dict(mk_rows[0], plain_device="cuda", rows=mk_rows)
    results["kraft"] = dict(kraft_rows[0], plain_device="cuda", rows=kraft_rows)

    # The planner's and splitter's scans at the shapes of the 4 MiB gzip
    # run (recorded above): the RLE sweep on every histogram batch the
    # planner gave it, the RLE statistics at every shape of the run (the
    # dynamic costs' one mask a call, the mask searches' 20), in both
    # modes, and the prefix tables on the splitter's 4 x 2^21 tokens,
    # beside torch.cumsum of their (W, n, 18) one-hot along the tokens
    # (P18's part; the one-hot built beforehand). Each against its plain
    # form on the card, with ms by events and the device ms of a call from
    # a trace. The bound counts the bytes this run's data needs (``need``:
    # the prefix tables read the tokens below n_tok), else every input and
    # output once (the statistics: the whole lit/off tables, te and the
    # outputs).
    def scan_row(name, label, kernel, plain, args, reps, library=None, need=None,
                 library_name="torch.cumsum"):
        got = kernel(*args)
        want = plain(*args)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = max(compare(f"{name} [{label}]", g, w) for g, w in pairs)
        outs = got if isinstance(got, tuple) else (got,)
        tensors = [a for a in args if torch.is_tensor(a)]
        row = dict(batch=label, shape=[list(a.shape) for a in tensors], max_abs_err=err,
                   ms=cuda_ms(lambda: kernel(*args), reps),
                   device_ms=device_ms(lambda: kernel(*args), name, reps),
                   plain_ms=cuda_ms(lambda: plain(*args), 1),
                   bound_ms=(bound_ms(*tensors, *outs) if need is None
                             else bytes_ms(need(args, outs))),
                   library_ms=None if library is None else cuda_ms(library, 3))
        print(f"{name} [{label}]: equal on {row['shape']}; kernel {row['ms']:.4f} ms (device "
              f"{fmt_ms(row['device_ms'])}), plain {row['plain_ms']:.3f} ms (cuda), bound "
              f"{row['bound_ms']:.4g} ms"
              + ("" if library is None else f", {library_name} {row['library_ms']:.4f} ms"))
        return row

    def over_run(name, rows, keys):  # rows[i] is the run's shape keys[i]
        for row, key in zip(rows, keys):
            row["run_launches"] = fused_calls[name][key]
        total = sum(r["run_launches"] * r["bound_ms"] for r in rows[:len(keys)])
        print(f"{name} over the run: {sum(fused_calls[name].values())} calls "
              f"({eager_counts[name]} launches counted), bound {total:.4g} ms")
        return total

    # The sweep: the planner's pair call (its (B, 288) and (B, 32)
    # histograms in one launch) at every lane count of the run, then each
    # set alone through the single-set entry.
    def sweep_plain(lit, off):
        return rle_cuda.optimize_for_rle_plain(lit), rle_cuda.optimize_for_rle_plain(off)

    sweep_keys = sorted(scan_args["rle_sweep"], reverse=True)
    sweep_rows = [scan_row("rle_sweep", f"planner pair {B} x {La} + {B} x {Lb}",
                           rle_cuda.optimize_for_rle_pair, sweep_plain,
                           scan_args["rle_sweep"][B, La, Lb], 20)
                  for B, La, Lb in sweep_keys]
    sweep_run_bound = over_run("rle_sweep", sweep_rows, sweep_keys)
    sweep_rows += [scan_row("rle_sweep", f"one set {tuple(rows.shape)}", rle_cuda.optimize_for_rle,
                            rle_cuda.optimize_for_rle_plain, (rows,), 20)
                   for key in sweep_keys for rows in scan_args["rle_sweep"][key]]
    results["rle_sweep"] = dict(sweep_rows[0], plain_device="cuda", rows=sweep_rows,
                                run_bound_ms=sweep_run_bound)

    # The RLE statistics take the code lengths themselves (the concatenation
    # in the kernel). Every shape of the run, both modes, beside the plain
    # form (the concatenation, then the statistics a mask, on the card), and
    # the launch floor: one lane of no length (rows already concatenated,
    # n_def 0).
    def stats_plain(lit, off, *rest):
        masks = rest[-1]
        lens, n_lit, n_off, n_def = rle_cuda.concat_lengths(lit, off)
        if len(rest) == 1:
            return (torch.cat([rle_cuda.rle_histogram_plain(lens, n_def, m) for m in masks]),
                    n_lit, n_off)
        B = lit.shape[0]
        return torch.cat([rle_cuda.rle_bits_plain(lens, n_def, rest[0][i * B:(i + 1) * B], m)
                          for i, m in enumerate(masks)])

    def stats_kernel(lit, off, *rest):
        if len(rest) == 1:
            return rle_cuda.rle_histogram_tables(lit, off, rest[0])
        return rle_cuda.rle_bits_tables(lit, off, *rest)

    stats_keys = sorted(scan_args["rle_stats"], key=lambda k: (-k[2], -k[1], k[0]))
    stats_rows = []
    for mode, B, M in stats_keys:
        args = scan_args["rle_stats"][mode, B, M]
        stats_rows.append(scan_row("rle_stats", f"{mode}, {B} lanes x {M} masks", stats_kernel,
                                   stats_plain, args, 20))
    floor_lens = torch.zeros((1, 19), dtype=torch.int32, device=dev)
    floor_nd = torch.zeros(1, dtype=torch.int32, device=dev)
    stats_floor = device_ms(lambda: rle_cuda.rle_histogram_masks(floor_lens, floor_nd, (7,)),
                            "rle_stats", 50)
    print(f"rle_stats launch floor (1 lane, n_def 0, 1 mask): device {fmt_ms(stats_floor)}")
    results["rle_stats"] = dict(stats_rows[0], plain_device="cuda", rows=stats_rows,
                                launch_floor_device_ms=stats_floor,
                                run_bound_ms=over_run("rle_stats", stats_rows, stats_keys))

    def prefix_need(args, outs):  # three int32 rows of the tokens below n_tok
        tokens = int(args[3].clamp(0, args[0].shape[1]).sum())
        return 12 * tokens + nbytes(args[3], *outs)

    # Also a lane of one 64 KiB window, as a window planned alone gives
    # the splitter (seeded tokens, a fifth of its bytes as the gzip run
    # has): the small call, 33 tiles. Each row also with the device time of
    # each of a call's three launches (count, scan, write).
    trng = np.random.default_rng(11)
    window_tokens = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        trng.integers(0, 18, (1, 1 << 16)), trng.integers(0, 286, (1, 1 << 16)),
        np.where(trng.random((1, 1 << 16)) < 0.4, trng.integers(288, 318, (1, 1 << 16)), 320),
        np.array([13107]))]
    prefix_keys = sorted(scan_args["prefix_tables"], reverse=True)
    prefix_calls = [(f"splitter {W_p} x {n_p}", scan_args["prefix_tables"][W_p, n_p])
                    for W_p, n_p in prefix_keys]
    prefix_rows = []
    for label, args in prefix_calls + [("one window 1 x 65536", window_tokens)]:
        onehot = ((args[0][:, :, None] == torch.arange(18, dtype=torch.int32, device=dev))
                  & (torch.arange(args[0].shape[1], device=dev)[None, :]
                     < args[3][:, None])[:, :, None]).to(torch.int32)
        prefix_rows.append(scan_row(
            "prefix_tables", label, prefix_cuda.prefix_tables, prefix_cuda.prefix_tables_plain,
            args, 10, library=lambda: torch.cumsum(onehot, dim=1, dtype=torch.int32),
            need=prefix_need))
        row = prefix_rows[-1]
        row["n_tok"] = args[3].tolist()
        row["launch_device_ms"] = launch_device_ms(lambda: prefix_cuda.prefix_tables(*args),
                                                   "prefix_tables", 10)
        print(f"prefix_tables [{label}]: n_tok {row['n_tok']}; device ms a launch "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(row["launch_device_ms"].items())))
        del onehot
    results["prefix_tables"] = dict(prefix_rows[0], plain_device="cuda", rows=prefix_rows,
                                    run_bound_ms=over_run("prefix_tables", prefix_rows,
                                                          prefix_keys))
    del scan_args

    # The planner's fused passes at the shapes of the 4 MiB gzip run
    # (recorded above): the DP's lane preparation on every bucket's first
    # pass, the token histograms of every bucket (the greedy call, whose
    # lengths and offsets are the match tables' first row, a view of
    # stride 8, and a convergence pass), the emission of every bucket, and
    # the (key, index) order of every row shape the planner and the
    # splitter sorted. Each against its plain form on the card, with ms by
    # events and the device ms of a call from a trace; the sort also beside
    # torch.sort(stable=True), its library call. The bound counts every
    # input read once and every output written once (of a strided view,
    # its elements alone); for the token histograms, of the lengths,
    # offsets and window bytes only those the marked positions need.
    def largest(rows):  # the row of the most bytes stands for the kernel
        return max(rows, key=lambda r: r["bound_ms"])

    prep_rows = [scan_row("prep_lanes", f"gzip bucket {tuple(args[2].shape)}",
                          dp_cuda.prep_lanes, dp_cuda.prep_lanes_plain, args, 5)
                 for _, args in sorted(buckets.items())]
    results["prep_lanes"] = dict(largest(prep_rows), plain_device="cuda", rows=prep_rows)

    def hist_kernel(w, ln, of, tok):
        return block_torch.token_hist(w, ln, of, None, tok)[:2]

    def hist_need(args, outs):  # every mark, a marked length, a match's offset, a literal
        _, lens, _, is_tok = args
        match = is_tok & (lens >= 3)
        return (is_tok.numel() + 4 * int(is_tok.sum()) + 4 * int(match.sum())
                + int((is_tok & ~match).sum()) + nbytes(*outs))

    hist_keys = sorted(fused_args["token_hist"])
    hist_rows_f = [scan_row(
        "token_hist", f"{'given marks' if given else 'chain marks'} {shape}", hist_kernel,
        block_torch.token_hist_plain, fused_args["token_hist"][shape, given], 5, need=hist_need)
        for shape, given in hist_keys]
    hist_run_bound = over_run("token_hist", hist_rows_f, hist_keys)
    # The lanes that hammer one bin (plan_cuda.hammer_lanes: a zero run of
    # 258-matches, one literal byte) at the single-lane bucket's width,
    # the chain's marks, contiguous rows and the stride-8 first slot.
    h_win, h_lens, h_offs, h_len = plan_cuda.hammer_lanes(131072, dev)
    h_marks = chain_cuda.chain_marks(torch.where(h_lens[:, :, 0] >= 3, h_lens[:, :, 0], 1),
                                     torch.zeros_like(h_len), h_len)
    for lane, what in enumerate(("zero-run lane", "one-byte lane")):
        sl = slice(lane, lane + 1)
        for label, ln, of in (("", h_lens[sl, :, 0].contiguous(), h_offs[sl, :, 0].contiguous()),
                              (", stride 8", h_lens[sl, :, 0], h_offs[sl, :, 0])):
            hist_rows_f.append(scan_row("token_hist", f"{what} (1, 131072){label}", hist_kernel,
                                        block_torch.token_hist_plain,
                                        (h_win[sl], ln, of, h_marks[sl]), 5, need=hist_need))
    results["token_hist"] = dict(largest(hist_rows_f), plain_device="cuda", rows=hist_rows_f,
                                 run_bound_ms=hist_run_bound)
    # The emission at every bucket of the run, then at the edges of its
    # tiling (``emit_edge_calls``). A call is the kernel and the memset
    # that zeroes its words, status words and ticket (the C entry's), so
    # its device ms are the two together, and its bound counts what the
    # call's output and this run's marks need: every mark, a marked
    # position's length, a match's offset, a literal's byte, the code
    # tables, and the whole (B, num_words) words and the totals written
    # once. Beside it, a torch.zeros of the same words (a fill kernel).
    def emit_need(args, outs):
        win, lens, offs, *tables, is_tok = args
        return hist_need((win, lens, offs, is_tok), outs) + nbytes(*tables)

    emit_keys = sorted(fused_args["emit_tokens"])
    emit_calls = [(f"gzip bucket {shape}", fused_args["emit_tokens"][shape])
                  for shape in emit_keys]
    emit_calls += list(emit_edge_calls(fused_args["emit_tokens"]).items())
    emit_rows = []
    for label, args in emit_calls:
        row = scan_row("emit_tokens", label, block_torch.emit_tokens,
                       block_torch.emit_tokens_plain, args, 5, need=emit_need)
        words = block_torch.emit_tokens(*args)[0]
        row["memset_device_ms"] = zeroing_device_ms(lambda: block_torch.emit_tokens(*args))
        if row["device_ms"] is None or row["memset_device_ms"] is None:
            raise SystemExit(f"emit_tokens [{label}]: a trace of its calls holds no kernel "
                             "or no memset")
        row["call_device_ms"] = row["device_ms"] + row["memset_device_ms"]
        row["bound_share"] = row["bound_ms"] / row["call_device_ms"]
        row["zeros_device_ms"] = zeroing_device_ms(
            lambda: torch.zeros(words.shape, dtype=words.dtype, device=dev))
        emit_rows.append(row)
        print(f"emit_tokens [{label}]: device ms a call {fmt_ms(row['call_device_ms'])} (the "
              f"kernel's and the memset's {fmt_ms(row['memset_device_ms'])}), "
              f"{row['bound_share']:.3f} of its bound; torch.zeros of its words "
              f"{fmt_ms(row['zeros_device_ms'])}")
    emit_run_bound = over_run("emit_tokens", emit_rows, emit_keys)
    emit_run = {k: sum(r["run_launches"] * (r[k] or 0.0) for r in emit_rows[:len(emit_keys)])
                for k in ("device_ms", "memset_device_ms", "call_device_ms", "zeros_device_ms")}
    print(f"emit_tokens over the run, device: kernel {emit_run['device_ms']:.4f} ms, memset "
          f"{emit_run['memset_device_ms']:.4f} ms, the calls {emit_run['call_device_ms']:.4f} ms, "
          f"{emit_run_bound / emit_run['call_device_ms']:.3f} of their bound; torch.zeros of "
          f"the words {emit_run['zeros_device_ms']:.4f} ms")
    results["emit_tokens"] = dict(largest(emit_rows), plain_device="cuda", rows=emit_rows,
                                  run_bound_ms=emit_run_bound, run_device_ms=emit_run)
    # Beside the run's shapes: rows of one repeated key (the splitter's
    # 4096 x 288 and one planner row) and rows of 1024 keys (MAX_SORT).
    lex_keys = sorted(fused_args["lex_order"], reverse=True)
    lex_calls = [(f"{B} rows x {S}", fused_args["lex_order"][B, S]) for B, S in lex_keys]
    lex_rng = np.random.default_rng(16)
    lex_calls += [("all-equal 4096 rows x 288", torch.full((4096, 288), 5, dtype=torch.int32,
                                                           device=dev)),
                  ("all-equal 1 rows x 288", torch.full((1, 288), 5, dtype=torch.int32,
                                                        device=dev))]
    lex_calls += [(f"1024 keys, {B} rows", torch.from_numpy(
        lex_rng.integers(-50, 50, (B, 1024)).astype(np.int32)).to(dev)) for B in (128, 1)]
    lex_rows = [scan_row("lex_order", label, entropy_torch._lex_order,
                         entropy_torch._lex_order_plain, (key,), 20,
                         library=lambda key=key: torch.sort(key, dim=1, stable=True),
                         library_name="torch.sort(stable=True)")
                for label, key in lex_calls]
    for row, (_, key) in zip(lex_rows, lex_calls):
        row["layout"] = plan_cuda.lex_order_layout(*key.shape)
    results["lex_order"] = dict(largest(lex_rows), plain_device="cuda", rows=lex_rows,
                                run_bound_ms=over_run("lex_order", lex_rows, lex_keys))
    del fused_args

    # matchlen: the pair (i, i - offset) of every position of the 4 MiB
    # corpus whose first match row has length >= 3, with the share of
    # their lengths at most 8, 16, 32 and 64 bytes and at 258 (it sets
    # matchlen_cuda.HEAD); a seeded edge batch on a copy of the first
    # 1 MiB with a 300-byte run; matchlen_cuda.edge_pairs (every p, q mod
    # 16, lengths around each head width, 258 and the cap, spans to the
    # end, bad indices) with the data at every base offset 0-15, ending
    # at the end of its buffer.
    corpus_dev = torch.from_numpy(corpus.copy()).to(dev)
    ml_pos, ml_prev = matchlen_hist_bench.match_pairs(corpus, lens, offs, mbs)
    edge_args = matchlen_hist_bench.edge_batch(corpus, dev)
    p_data, p_pos, p_prev = matchlen_cuda.edge_pairs()
    planted = [torch.empty(off + len(p_data), dtype=torch.uint8, device=dev)[off:]
               for off in range(16)]
    for x in planted:
        x.copy_(torch.from_numpy(p_data))
    p_pos, p_prev = torch.from_numpy(p_pos).to(dev), torch.from_numpy(p_prev).to(dev)
    ml_rows = []
    for label, args in (("corpus match pairs", (corpus_dev, ml_pos, ml_prev)),
                        ("edge batch", edge_args),
                        ("edge pairs, base offsets 0-15", (planted[0], p_pos, p_prev))):
        got = matchlen_cuda.match_lengths(*args)
        want, plain = host_ms(lambda: matchlen_cuda.match_lengths_plain(*args).cpu())
        err = compare("matchlen", got, want)
        if label.startswith("edge pairs"):
            for off, x in enumerate(planted[1:], 1):
                compare(f"matchlen at base offset {off}",
                        matchlen_cuda.match_lengths(x, p_pos, p_prev), want)
        ml_rows.append(dict(batch=label, pairs=int(args[1].numel()), max_abs_err=err,
            ms=cuda_ms(lambda: matchlen_cuda.match_lengths(*args), 10),
            device_ms=device_ms(lambda: matchlen_cuda.match_lengths(*args), "matchlen", 10),
            plain_ms=plain, bound_ms=bound_ms(*args, got), head=matchlen_cuda.HEAD,
            n_258=int((got == 258).sum())))
        r = ml_rows[-1]
        if label == "corpus match pairs":
            r["length_shares"] = {**{f"le_{k}": int((want <= k).sum()) / max(want.numel(), 1)
                                     for k in (8, 16, 32, 64)},
                                  "eq_258": int((want == 258).sum()) / max(want.numel(), 1)}
        print(f"matchlen [{label}]: equal on {args[1].numel()} pairs over {args[0].numel()} B; "
              f"kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), plain {plain:.1f} ms "
              f"(cuda), bound {r['bound_ms']:.4g} ms; {r['n_258']} pairs at 258"
              + (f"; lengths {r['length_shares']}" if "length_shares" in r else ""))
    if ml_rows[1]["n_258"] < 1 or ml_rows[2]["n_258"] < 1:
        raise SystemExit("matchlen: an edge batch has no pair at the 258 cap")
    results["matchlen"] = dict(ml_rows[0], plain_device="cuda", rows=ml_rows)

    # Byte histogram: the 4 MiB corpus (n_symbols 256 and 200, and an
    # unaligned view), a seeded 64 MiB buffer, past the TPU kernel's
    # 2^24-byte chunk, and 64 MiB of one value (every count on one bin).
    # Each against its plain form and torch.bincount, with the device time
    # of the kernel, of all of a call's kernels and of bincount's.
    big = torch.from_numpy(np.random.default_rng(4).integers(0, 256, 64 << 20, np.uint8)).to(dev)
    one = torch.full((64 << 20,), 211, dtype=torch.uint8, device=dev)
    hist_rows = []
    for label, x, n_sym in (("4 MiB corpus", corpus_dev, 256), ("4 MiB corpus", corpus_dev, 200),
                            ("corpus[1:] (unaligned)", corpus_dev[1:], 256),
                            ("64 MiB seeded", big, 256), ("64 MiB one value", one, 256)):
        got = histogram_cuda.byte_histogram(x, n_sym)
        want = histogram_cuda.byte_histogram_plain(x, n_sym)
        lib = torch.bincount(x, minlength=256)[:n_sym]
        err = compare("hist", got, want)
        compare("hist vs torch.bincount", got, lib)
        hist_rows.append(dict(
            batch=label, n=int(x.numel()), n_symbols=n_sym, max_abs_err=err,
            ms=cuda_ms(lambda: histogram_cuda.byte_histogram(x, n_sym), 20),
            device_ms=device_ms(lambda: histogram_cuda.byte_histogram(x, n_sym), "hist", 20),
            call_device_ms=device_ms(lambda: histogram_cuda.byte_histogram(x, n_sym), None, 20),
            plain_ms=cuda_ms(lambda: histogram_cuda.byte_histogram_plain(x, n_sym), 5),
            library_ms=cuda_ms(lambda: torch.bincount(x, minlength=256), 20),
            library_device_ms=device_ms(lambda: torch.bincount(x, minlength=256), None, 20),
            bound_ms=bound_ms(x, got)))
        r = hist_rows[-1]
        print(f"hist [{label}, n_symbols {n_sym}]: equal to its plain form and to "
              f"torch.bincount on {x.numel()} B; kernel {r['ms']:.4f} ms (device "
              f"{fmt_ms(r['device_ms'])}, all of a call {fmt_ms(r['call_device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ms, bincount {r['library_ms']:.4f} ms (device "
              f"{fmt_ms(r['library_device_ms'])}) (cuda), bound {r['bound_ms']:.4g} ms")
    del big, one
    results["hist"] = dict(hist_rows[0], plain_device="cuda", rows=hist_rows)

    # -- the one-shot path end to end, every golden case ----------------
    def timed_run(label, case, d, dictionary, fn):
        """Run ``fn`` with the counts set to 0; check its output and the
        twelve path kernels' launches. -> (output, seconds, launches)"""
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got_counts = path_counts(label, launch_counts())
        check_output(label, case, d, dictionary, out)
        return out, secs, got_counts

    def one_shot(case, d, dictionary):
        return compress_device(d, case["flags"], case["block_size"], dictionary, device=dev)

    def streamed(case, d):
        stream = Stream(case["flags"], case["block_size"], device=dev)
        pieces = [stream.compress(d[i : i + cli.CHUNK_SIZE])
                  for i in range(0, len(d), cli.CHUNK_SIZE)]
        pieces.append(stream.compress(b"", FINALIZE))
        return b"".join(pieces)

    first = {}  # name -> (seconds, launches) of each case's one-shot run
    captured_golden = {p["key"] for p in programs.captured(dev)}
    for case in golden:
        name = case["name"]
        d, dictionary = inputs[name]
        out, secs, got_counts = timed_run(name, case, d, dictionary,
                                          lambda: one_shot(case, d, dictionary))
        first[name] = (secs, got_counts)
        if name == "gzip":
            counts = launch_counts()
            print(f"one-shot gzip {len(d)} B -> {len(out)} B, equal to the golden digest, "
                  f"decodes; port {len(d) / 1e6 / secs:.3f} MB/s ({secs:.2f} s) on {smi}; "
                  f"launches {got_counts}")
            # By now the programs of the shapes the first gzip run met are
            # captured (the kernel phases' own gzip calls come between), this
            # run captured no other, and it launched what the first launched.
            if counts != eager_counts:
                raise SystemExit(f"programs: the capturing gzip run launched {counts}, the "
                                 f"eager first run {eager_counts}")
            captured_now = {p["key"] for p in programs.captured(dev)}
            if not gzip_keys <= captured_now or (captured_now - captured_golden) - gzip_keys:
                raise SystemExit("programs: the gzip shapes are not all captured, or the gzip "
                                 "run captured others")
            gzip_programs = [p for p in programs.captured(dev) if p["key"] in gzip_keys]
            gzip_pool = programs.pool_bytes(dev)
        else:
            print(f"{name}: {len(d)} B -> {len(out)} B, equal to the golden digest, decodes "
                  f"({secs:.2f} s); launches {got_counts}")

    # -- the programs: the match stage, the planner and the splitter as CUDA graphs
    # Every program captured so far (the gzip run's, then those of the
    # other cases that met a shape twice), replayed on the inputs of its last call with
    # set_sync_debug_mode("error") around the replay, against an eager call
    # of its function on the same inputs: every output equal.
    rows = programs.replay_against_eager(dev)
    for r in rows:
        if r["max_abs_err"] != 0:
            raise SystemExit(f"programs: {r['text']} replays unlike its eager call "
                             f"(max abs err {r['max_abs_err']})")
        print(f"program {r['text']}{' (gzip run)' if r['key'] in gzip_keys else ''}: replay "
              f"equal to the eager call (max abs err 0), no sync in the replay; launches a "
              f"replay {r['launches']}; capture {r['capture_ms']:.1f} ms, replay "
              f"{r['replay_ms']:.4f} ms, eager {r['eager_ms']:.4f} ms (events)")
    match_rows = [r for r in rows if r["key"] in gzip_keys
                  and r["key"][0] is matchfinder_torch.match_program]
    if len(match_rows) != 1:
        raise SystemExit(f"programs: the gzip run captured {len(match_rows)} match programs, "
                         "not one")
    r = match_rows[0]
    print(f"match program (gzip run, {r['text']}): captured; replay equal to the eager call "
          f"(max abs err {r['max_abs_err']}) under set_sync_debug_mode('error'); replay "
          f"{r['replay_ms']:.4f} ms, capture {r['capture_ms']:.1f} ms, eager {r['eager_ms']:.4f} "
          f"ms; launches a replay {r['launches']}; on {smi}")
    print(f"programs: the gzip run captured {len(gzip_programs)} graphs, pool {gzip_pool} B; "
          f"{len(rows)} graphs after every golden case, pool {programs.pool_bytes(dev)} B, "
          f"peak reserved {torch.cuda.max_memory_reserved()} B; the capturing gzip run's "
          f"launches equal the eager first run's ({eager_counts}); on {smi}")

    by_name = {case["name"]: case for case in golden}

    # -- sharded: the staircase match finder, compress_sharded, optimize_matches
    # The staircase on the gzip case's segments at compress_sharded's 64 KiB
    # cores: equal to the walk's rows on every segment that does not
    # overflow, and to its own CPU run on two segments; ms a segment of the
    # staircase program's replay and of the walk (with and without its
    # suffix arrays), by events. Then compress_sharded on the gzip and
    # dictionary cases over one and two devices (a first call and a replay
    # each), a zero-heavy input whose segments overflow (against
    # compress_device), and optimize_matches on a 1 MiB block against its
    # CPU run. Each compression runs with the counts set to 0 just before.
    from zultra_tpu_torch.constants import (static_literal_code_lengths,
                                            static_offset_code_lengths)
    from zultra_tpu_torch.ops import parse_torch, staircase_torch
    from zultra_tpu_torch.parallel import compress_sharded

    torch.cuda.reset_peak_memory_stats()
    core = staircase_torch.STAIRCASE_CORE
    segbufs, _ = matchfinder_torch.build_segments(corpus, spans, core)
    seg_dev = torch.from_numpy(segbufs).to(dev)
    stats0 = dict(staircase_torch.FALLBACK_STATS)
    st_rows = staircase_torch.sharded_rows(segbufs, [dev], 16, core)
    stats1 = dict(staircase_torch.FALLBACK_STATS)
    n_seg = stats1["segments"] - stats0["segments"]
    n_over = stats1["overflowed"] - stats0["overflowed"]
    walked = walk_cuda.walk_segments(matchfinder_torch.salcp_batch(seg_dev), HALO, core)
    batch = staircase_torch.PROGRAM_SEGMENTS  # the program's shape: replays
    lens_s, offs_s, over_s = (torch.cat(x) for x in zip(*(
        staircase_torch.staircase_segments(seg_dev[i : i + batch], 16, HALO, core)
        for i in range(0, len(segbufs), batch))))
    ok = ~over_s
    compare("staircase against the walk (lengths)", lens_s[ok], walked[ok] >> 16)
    compare("staircase against the walk (offsets)", offs_s[ok], walked[ok] & 0xFFFF)
    compare("staircase rows with the overflows walked", st_rows, walked)
    cpu_two = staircase_torch.staircase_segments(seg_dev[:2].cpu(), 16, HALO, core)
    for label, g, w in zip(("lengths", "offsets", "overflow"), (lens_s, offs_s, over_s), cpu_two):
        compare(f"staircase on the card against its CPU run ({label})", g[:2], w)
    # ms a segment at the program's batch (replays) and at 32 segments a
    # call (an eager call of the program's function), beside the walk on
    # the same segments at each batch and on all of them in one call (as
    # the match program walks a batch), with and without its suffix arrays.
    per_seg = {}
    for b in (batch, 32):
        if b == batch:
            per_seg["staircase", b] = cuda_ms(lambda: staircase_torch.staircase_segments(
                seg_dev[:b], 16, HALO, core), 3) / b
        else:
            per_seg["staircase", b] = cuda_ms(lambda: staircase_torch.staircase_program(
                seg_dev[:b], budget_factor=16, core_off=HALO, core_len=core), 3) / b
    for b in (batch, 32, len(segbufs)):
        salcp = matchfinder_torch.salcp_batch(seg_dev[:b])
        per_seg["walk", b] = cuda_ms(lambda: walk_cuda.walk_segments(salcp, HALO, core), 3) / b
        per_seg["walk with suffix arrays", b] = cuda_ms(lambda: walk_cuda.walk_segments(
            matchfinder_torch.salcp_batch(seg_dev[:b]), HALO, core), 3) / b
    del salcp, walked, lens_s, offs_s, st_rows, seg_dev
    print(f"staircase: gzip case, {n_seg} segments of {segbufs.shape[1]} words ({core} core), "
          f"{n_over} overflowed; rows equal to the walk's on every segment that does not "
          f"overflow and to its CPU run on two; ms a segment (events), by segments a call: "
          + "; ".join(f"{k} at {b} {v:.4f}" for (k, b), v in per_seg.items())
          + "; ratio staircase / walk with suffix arrays " + ", ".join(
              f"{per_seg['staircase', b] / per_seg['walk with suffix arrays', b]:.2f} at {b}"
              for b in (batch, 32)) + f"; on {smi}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    sharded_kernels = tuple(k for k in COMPRESS_KERNELS if k != "walk")
    for name in ("gzip", "dictionary"):
        case = by_name[name]
        d, dictionary = inputs[name]
        for devs in (["cuda:0"], ["cuda:0", "cuda:0"]):
            times = []
            for _ in range(2):  # a first call, then a replay of its programs
                reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = compress_sharded(d, devs, case["flags"], case["block_size"],
                                       dictionary=dictionary)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                got_counts = path_counts(f"sharded {name}", launch_counts(), sharded_kernels)
                check_output(f"sharded {name} {devs}", case, d, dictionary, out)
            print(f"compress_sharded {name} {devs}: {len(d)} B equal to the golden digest, "
                  f"decodes; first call {times[0]:.3f} s, replay {times[1]:.3f} s "
                  f"({len(d) / 1e6 / times[1]:.3f} MB/s; one-shot {first[name][0]:.3f} s) on "
                  f"{smi}; launches {got_counts}")

    zero_heavy = data[: 1 << 18] + bytes(1 << 19) + data[1 << 18 : 1 << 19]
    stats0 = dict(staircase_torch.FALLBACK_STATS)
    reset_launch_counts()
    out = compress_sharded(zero_heavy, ["cuda:0", "cuda:0"], 2)
    got_counts = path_counts("sharded zero-heavy", launch_counts())
    over = staircase_torch.FALLBACK_STATS["overflowed"] - stats0["overflowed"]
    if over <= 0:
        raise SystemExit("sharded zero-heavy: no segment overflowed its membership budget")
    if out != compress_device(zero_heavy, 2, device=dev) or zlib.decompress(out, 31) != zero_heavy:
        raise SystemExit("sharded zero-heavy: not equal to compress_device's bytes")
    print(f"compress_sharded zero-heavy: {len(zero_heavy)} B ({1 << 19} B of zeros), "
          f"{over} of {staircase_torch.FALLBACK_STATS['segments'] - stats0['segments']} "
          f"segments overflowed and were walked, equal to compress_device's bytes, decodes; "
          f"launches {got_counts}")

    window = corpus[: HALO + (1 << 20)]
    table = matchfinder_torch.match_table(window, HALO, len(window), dev)
    job = (static_literal_code_lengths(), static_offset_code_lengths(), window, table, HALO,
           len(window))
    got = parse_torch.optimize_matches(*job, device=dev)
    want, plain = host_ms(lambda: parse_torch.optimize_matches(*job, device="cpu"))
    if not np.array_equal(got, want):
        raise SystemExit("optimize_matches: the card's choices differ from the CPU run's")
    om_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        om_ms.append(host_ms(lambda: parse_torch.optimize_matches(*job, device=dev))[1])
    print(f"optimize_matches: one 1 MiB block after 32 KiB of history (the fixed Huffman "
          f"code lengths), equal to its CPU run; {min(om_ms):.2f} ms (host clock, best of 3: "
          f"{', '.join(f'{t:.2f}' for t in om_ms)}), CPU {plain:.1f} ms, on {smi}")
    print(f"sharded phase: peak reserved {torch.cuda.max_memory_reserved()} B over the "
          f"compressions and optimize_matches (after the staircase timings); on {smi}")

    # The one-shot's graphs after the sharded phase: still captured, and a
    # gzip run replays them (captures nothing new, launches what it did).
    captured_keys = {p["key"] for p in programs.captured(dev)}
    staircase_keys = [p["text"] for p in programs.captured(dev)
                      if p["key"][0] is staircase_torch.staircase_program]
    print(f"programs after the sharded phase: {len(captured_keys)} graphs, the staircase's "
          f"{staircase_keys}; the gzip run's {len(gzip_keys & captured_keys)} of "
          f"{len(gzip_keys)} still captured")
    case = by_name["gzip"]
    _, secs, got_counts = timed_run("gzip after the sharded phase", case, data, None,
                                    lambda: one_shot(case, data, None))
    if got_counts != first["gzip"][1] or {p["key"] for p in programs.captured(dev)} \
            != captured_keys or not gzip_keys <= captured_keys:
        raise SystemExit("programs: the gzip one-shot after the sharded phase did not replay "
                         "its graphs")
    print(f"one-shot gzip after the sharded phase: replayed its graphs, captured none, "
          f"{secs:.3f} s; launches {got_counts}")

    # -- the streaming push API: Stream fed in the CLI's 16 KiB chunks ----
    # In turns with the one-shot path: one-shot (above), stream, stream,
    # one-shot, so that a drift of the card or host over the run falls
    # on both sides.
    replayed = {}  # name -> seconds of a one-shot run that replays every program
    for name in ("gzip", "stream"):
        case = by_name[name]
        d, _ = inputs[name]
        runs = [timed_run(f"stream {name}", case, d, None, lambda: streamed(case, d))
                for _ in range(2)]
        again = timed_run(name, case, d, None, lambda: one_shot(case, d, None))
        if again[2] != first[name][1]:
            raise SystemExit(f"programs: a later {name} run launched {again[2]}, its capturing "
                             f"run {first[name][1]}")
        replayed[name] = again[1]
        s_secs = [r[1] for r in runs]
        o_secs = [first[name][0], again[1]]
        mb = len(d) / 1e6
        print(f"stream {name}: {len(d)} B in {cli.CHUNK_SIZE} B chunks, equal to the golden "
              f"digest, decodes; stream {2 * mb / sum(s_secs):.3f} MB/s (runs "
              f"{s_secs[0]:.2f}, {s_secs[1]:.2f} s) vs one-shot {2 * mb / sum(o_secs):.3f} MB/s "
              f"(runs {o_secs[0]:.2f}, {o_secs[1]:.2f} s) on {smi}; launches stream "
              f"{runs[0][2]} one-shot {first[name][1]}")

    # -- the CLI: -c on the deflate case's input, -cbench, -quicktest ------
    case = by_name["deflate"]
    d, _ = inputs["deflate"]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.deflate"
        src.write_bytes(d)
        for mode, argv in (("-c", ["-deflate", "-c", str(src), str(dst)]),
                           ("-cbench", ["-deflate", "-cbench", str(src)]),
                           ("-quicktest", ["-quicktest"])):
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"cli {mode}: exit code {rc}")
            got_counts = path_counts(f"cli {mode}", launch_counts())
            if mode == "-c":
                check_output("cli -c", case, d, None, dst.read_bytes())
            print(f"cli {mode}: exit 0 in {secs:.2f} s"
                  f"{', output equal to the deflate digest' if mode == '-c' else ''}; "
                  f"launches {got_counts}")


    # -- many windows, devices and processes ---------------------------------
    # Each phase runs with the counts set to 0 just before it and read just
    # after; none catches its own failure.
    path_launches = {k: counts[k] for k in COMPRESS_KERNELS}  # the gzip one-shot run's

    def per_window(case, d, dictionary):
        """Every window planned alone through the engine's per-window
        contract, emitted in stream order, framed as compress_device."""
        engine = DeviceWindowEngine(dev)
        mbs_c = clamp_block_size(case["block_size"])
        flags = case["flags"]
        dict_b = dictionary or b""
        corpus_c = np.frombuffer(dict_b + d, np.uint8)
        base = len(dict_b)
        out = bytearray(frame.encode_header(flags, dictionary))
        buf = bytearray(memory_bound(mbs_c, flags, mbs_c))
        bits_data = bits_count = 0
        spans_c = [(base + lo, base + min(lo + mbs_c, len(d))) for lo in range(0, len(d), mbs_c)]
        for i, (lo, hi) in enumerate(spans_c):
            prev = min(32768, lo)
            handle = engine.begin_window(corpus_c[lo - prev : hi], prev, hi - lo)
            n_out, bits_data, bits_count = engine.emit_window(
                handle, i + 1 == len(spans_c), buf, bits_data, bits_count)
            engine.free_window(handle)
            out += buf[:n_out]
        out += frame.encode_footer(flags, frame.update_checksum(
            frame.init_checksum(flags), corpus_c[base:], flags), len(d))
        return bytes(out)

    # Each of these phases runs three times: its first run meets the
    # shapes of its own programs (a batch of another width) eagerly, the
    # second captures them, the third replays them. The one-shot times
    # beside them are replays too.
    def thrice(label, case, d, dictionary, fn):
        runs = [timed_run(label, case, d, dictionary, fn) for _ in range(3)]
        return [r[1] for r in runs], runs[2][2]

    case = by_name["zlib"]
    d, dictionary = inputs["zlib"]
    secs, got_counts = thrice("per-window zlib", case, d, dictionary,
                             lambda: per_window(case, d, dictionary))
    for _ in range(2):  # the one-shot's shapes met above: a capturing run, then a replay
        _, one, _ = timed_run("zlib", case, d, dictionary, lambda: one_shot(case, d, dictionary))
    n_windows = -(-len(d) // clamp_block_size(case["block_size"]))
    print(f"per-window zlib: {n_windows} windows of {case['block_size']} B each planned alone "
          f"(begin_window + emit_window), equal to the golden digest, decodes; "
          f"{len(d) / 1e6 / secs[2]:.3f} MB/s ({secs[2]:.2f} s; first runs {secs[0]:.2f}, "
          f"{secs[1]:.2f} s) "
          f"against one-shot {len(d) / 1e6 / one:.3f} MB/s ({one:.2f} s; its first run "
          f"{first['zlib'][0]:.2f} s), ratio {one / secs[2]:.3f}, on {smi}; launches {got_counts}")

    case = by_name["stream"]
    d, _ = inputs["stream"]
    for wpb in (2, 5):
        secs, got_counts = thrice(
            f"windows_per_batch {wpb}", case, d, None,
            lambda: compress_device(d, case["flags"], case["block_size"], windows_per_batch=wpb,
                                    device=dev))
        print(f"windows_per_batch {wpb}: stream case ({len(d)} B, 33 windows) equal to the golden "
              f"digest, decodes; {secs[2]:.2f} s ({len(d) / 1e6 / secs[2]:.3f} MB/s; first runs "
              f"{secs[0]:.2f}, {secs[1]:.2f} s; 16 a batch: {replayed['stream']:.2f} s) on {smi}; "
              f"launches "
              f"{got_counts}")

    case = by_name["gzip"]
    d, _ = inputs["gzip"]
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n_cards)] if n_cards > 1 else ["cuda:0", "cuda:0"]
    secs, got_counts = thrice(
        "devices", case, d, None,
        lambda: compress_device(d, case["flags"], case["block_size"], devices=devices))
    print(f"devices {devices}: gzip case equal to the golden digest, decodes; {secs[2]:.2f} s "
          f"({len(d) / 1e6 / secs[2]:.3f} MB/s; first runs {secs[0]:.2f}, {secs[1]:.2f} s; one "
          f"device "
          f"{replayed['gzip']:.2f} s) on {smi}; launches {got_counts}")

    t0 = time.perf_counter()
    out, rank_stats = multihost.run_windows_distributed(
        d, case["flags"], case["block_size"], world_size=2, device="cuda:0", timeout=600)
    secs = time.perf_counter() - t0
    check_output("distributed gzip", case, d, None, out)
    got_counts = path_counts("distributed gzip", {
        k: sum(st["launches"][k] for st in rank_stats) for k in KERNELS})
    print(f"distributed gzip: 2 gloo ranks on cuda:0 (spawned), rank 0's stream equal to the "
          f"golden digest, decodes; {secs:.2f} s with the processes' start (one process "
          f"one-shot {first['gzip'][0]:.2f} s); plan s by rank "
          f"{[round(st['plan_s'], 3) for st in rank_stats]}, allgather s "
          f"{[round(st['allgather_s'], 3) for st in rank_stats]}, stitch "
          f"{rank_stats[0]['stitch_s']:.3f} s, on {smi}; launches (both ranks) {got_counts}")

    # Corpus statistics of the 4 MiB corpus at 64 KiB windows (64 windows,
    # no padding) and the checksums, against torch.bincount and zlib.
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = sharded_corpus_stats(data, devices=[dev])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    path_launches["hist"] = path_counts("corpus statistics", launch_counts(), ("hist",))["hist"]
    windows = corpus_dev.view(stats["n_windows"], -1)
    if not torch.equal(torch.from_numpy(stats["corpus_histogram"]),
                       torch.bincount(corpus_dev, minlength=256).cpu()):
        raise SystemExit("corpus statistics: the histogram differs from torch.bincount")
    rank_of_sa = torch.gather(stats["ranks"], 1, stats["suffix_arrays"].to(torch.int64))
    if not torch.equal(rank_of_sa, torch.arange(windows.shape[1], device=dev,
                                                dtype=torch.int32).expand_as(rank_of_sa)):
        raise SystemExit("corpus statistics: the suffix arrays and final ranks disagree")
    adler = 1
    for s1, s2 in zip(stats["adler_s1"], stats["adler_s2"]):
        w_len = windows.shape[1]
        adler = checksum.adler32_combine(adler, ((int(s2 + w_len) % 65521) << 16)
                                         | (int(s1 + 1) % 65521), w_len)
    half = len(data) // 2 + 7
    checks = {
        "window partials folded": adler == zlib.adler32(data),
        "adler32 on the card": checksum.adler32(corpus, device=dev) == zlib.adler32(data),
        "adler32_combine": checksum.adler32_combine(zlib.adler32(data[:half]), zlib.adler32(
            data[half:]), len(data) - half) == zlib.adler32(data),
        "crc32_combine": checksum.crc32_combine(zlib.crc32(data[:half]), zlib.crc32(
            data[half:]), len(data) - half) == zlib.crc32(data),
        "crc32_sharded": checksum.crc32_sharded(
            [data[i : i + (1 << 20)] for i in range(0, len(data), 1 << 20)]) == zlib.crc32(data),
    }
    if not all(checks.values()):
        raise SystemExit(f"checksums: not equal to zlib: {checks}")
    print(f"corpus statistics: {stats['n_windows']} windows of 64 KiB, histogram equal to "
          f"torch.bincount, suffix arrays consistent with their ranks, {secs:.3f} s on {smi}; "
          f"hist launches {path_launches['hist']}; checksums equal to zlib: {sorted(checks)}")

    # write_tokens on the first block of the gzip case's first planner
    # bucket: its chosen parse and codes, against the planner's own words.
    args, (words, total_bits), lengths = emitted["args"], emitted["out"], emitted["length"]
    L = int(lengths[0])
    best = torch.stack([args[1][0, :L], args[2][0, :L]], dim=1).cpu().numpy()
    window = args[0][0, :L].cpu().numpy()
    lit = types.SimpleNamespace(code_word=args[3][0].tolist(), code_length=args[4][0].tolist())
    off = types.SimpleNamespace(code_word=args[5][0].tolist(), code_length=args[6][0].tolist())
    want_bits = int(total_bits[0])
    want = words[0].cpu().numpy().astype(np.uint32).view(np.uint8)[: (want_bits + 7) // 8].copy()
    if want_bits & 7:
        want[-1] &= (1 << (want_bits & 7)) - 1
    reset_launch_counts()
    t0 = time.perf_counter()
    got = write_tokens(window, best, 0, L, lit, off, device=dev)
    secs = time.perf_counter() - t0
    got_counts = path_counts("write_tokens", launch_counts(), ("chain",))
    plain = write_tokens(window, best, 0, L, lit, off, device="cpu")
    if got[1] != want_bits or got[0] != want.tobytes() or got != plain:
        raise SystemExit(f"write_tokens: {got[1]} bits against the plan's {want_bits}, or bytes "
                         "not equal to the plan's words or to the plain form")
    print(f"write_tokens: one block of {L} B of the gzip plan, {got[1]} bits equal to the "
          f"plan's total_bits, bytes equal to its words and to the plain form (cpu); "
          f"{secs * 1e3:.2f} ms; launches {got_counts}")

    kernels = []
    for name, (source, replaces) in {**KERNELS, **OFF_PATH_KERNELS}.items():
        r = results[name]
        extra = {} if name in KERNELS else {"path": "no path runs it"}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": path_launches.get(name, 0), "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes", "library_ms": r.get("library_ms"), **extra,
                        **{k: v for k, v in r.items() if k not in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
