"""Smoke run of zultra_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Runs in phases, each a function that ``main`` calls in turn:

1. build: the CUDA kernels from zultra_tpu_torch/csrc/ (one nvcc per
   source, sm_90a), with each source's ``-Xptxas -v`` report.
2. kernels: every family of ``zultra_tpu_torch.kernel_bench``, each in a
   process of its own: each kernel held against its plain form at the
   shapes the one-shot path gives it (the 4 MiB gzip case's windows and
   its recorded planner and splitter calls) and at seeded edges, with its
   ms by events, its device ms from a trace and its byte bound. The
   smoke's own recorded compression of the case is its process's first:
   its programs' first calls run eagerly.
3. golden: every case of zultra_tpu_torch/smoke_golden.json in one shot
   (a seeded 4 MiB mixed corpus in gzip, four 1 MiB windows in one device
   batch; deflate; zlib at 64 KiB blocks; a preset dictionary;
   incompressible bytes; 2 MiB at 64 KiB blocks, 33 windows in three
   batches; text at 2 MiB blocks). The gzip run must capture the
   programs of the shapes the recorded run met and no other, and launch
   what that eager run launched.
4. programs: every program captured so far replayed against an eager
   call of its function on the same inputs (``programs.replay_against_
   eager``: every output equal, no sync inside the replay), the gzip
   run's match program among them.
5. sharded: the staircase match finder on the gzip case's segments at
   64 KiB cores (equal to the walk's rows where no segment overflows and
   to its own CPU run on two; ms a segment by events beside the walk's),
   ``parallel.compress_sharded`` on the gzip and dictionary cases over
   one and two devices (a first call and a replay each) and on a
   zero-heavy input whose segments overflow (equal to
   ``compress_device``'s bytes), ``ops.optimize_matches`` on a 1 MiB
   block against its CPU run, then a gzip one-shot run that must replay
   its graphs.
6. stream and CLI: the gzip and 33-window cases through ``Stream`` in
   16 KiB chunks, twice, then one-shot again (launching what its first
   run did); the CLI's ``-c``, ``-cbench`` and ``-quicktest``.
7. windows, devices and processes: every window of the zlib case planned
   alone (``DeviceWindowEngine.begin_window`` + ``emit_window``), the
   33-window case at ``windows_per_batch`` 2 and 5, the gzip case over a
   ``devices`` list (every card torch sees, or ``cuda:0`` twice), each
   three times (its shapes met eagerly, captured, replayed); the gzip case
   in windows mode across 2 spawned gloo ranks on ``cuda:0``
   (``parallel.multihost.run_windows_distributed``); corpus statistics of
   the 4 MiB corpus (``parallel.sharded_corpus_stats``) with the
   checksums against zlib; ``ops.emit_torch.write_tokens`` on one block
   of the gzip case's plan.

Each compression must rebuild the recorded input (sha256), match the
recorded output digest (what zultra_tpu writes on its native engine),
decode with zlib, and launch every compression kernel, counted from 0
just before it (the statistics the histogram kernel, ``write_tokens``
the chain kernel; the distributed ranks report their own counts; a
sharded compression all but the walk, and the walk where a segment
overflowed). Prints the card's name and power limit, one line per check
and kernel row, a JSON line of the kernels' results and, last,
{"ok": true, "device": {...}}. Exits non-zero on any failure, and with 2
before any result when no CUDA device is present. Imports nothing of
zultra_tpu.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
import types
import zlib
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zultra_tpu_torch import (FINALIZE, DeviceWindowEngine, Stream, _build, cli,  # noqa: E402
                              compress_device, frame, kernel_bench)
from zultra_tpu_torch.constants import (static_literal_code_lengths,  # noqa: E402
                                        static_offset_code_lengths)
from zultra_tpu_torch.kernel_bench import compare, events_ms, host_ms  # noqa: E402
from zultra_tpu_torch.ops import (checksum, launch_counts, matchfinder_torch,  # noqa: E402
                                  parse_torch, programs, reset_launch_counts,
                                  staircase_torch, walk_cuda)
from zultra_tpu_torch.ops.emit_torch import write_tokens  # noqa: E402
from zultra_tpu_torch.ops.matchfinder_torch import HALO  # noqa: E402
from zultra_tpu_torch.parallel import (compress_sharded, multihost,  # noqa: E402
                                       sharded_corpus_stats)
from zultra_tpu_torch.stream import clamp_block_size, memory_bound  # noqa: E402

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
ROW_FIELDS = ("batch", "max_abs_err", "ms", "device_ms", "plain_ms", "plain_device", "bound_ms")


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def row_text(kernel: str, row: dict) -> str:
    """One line of a kernel row: the check, the times, then its other fields."""
    rest = "; ".join(f"{k} {v}" for k, v in row.items() if k not in ROW_FIELDS)
    return (f"{kernel} [{row['batch']}]: equal to its plain form (max abs err "
            f"{row['max_abs_err']}); kernel {fmt_ms(row['ms'])} (device "
            f"{fmt_ms(row['device_ms'])} a call), plain {fmt_ms(row['plain_ms'])} "
            f"({row['plain_device']}), bound {fmt_ms(row['bound_ms'])}; {rest}")


def check_output(name: str, case: dict, data: bytes, dictionary, out: bytes) -> None:
    """Raise unless ``out`` equals the case's golden digest and zlib
    decodes it to ``data``."""
    if len(out) != case["out_len"] or hashlib.sha256(out).hexdigest() != case["out_sha256"]:
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


def checked_run(label, case, data, dictionary, fn) -> tuple:
    """Run ``fn`` with the launch counts set to 0; check its output and
    the path kernels' launches. -> (output, launches)"""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got_counts = path_counts(label, launch_counts())
    check_output(label, case, data, dictionary, out)
    return out, got_counts


def one_shot(case, data, dictionary, dev):
    return compress_device(data, case["flags"], case["block_size"], dictionary, device=dev)


def captured_keys(dev) -> set:
    return {p["key"] for p in programs.captured(dev)}


def build_phase() -> str:
    """Build the kernels; print the card, the build and nvcc's reports."""
    smi = kernel_bench.card()
    print(smi)
    print(f"card: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for src, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if line.strip():
                print(f"nvcc -Xptxas -v {src}.cu: {line.strip()}")
    return smi


def kernel_phase(g) -> tuple:
    """Every family of kernel_bench, each in a process of its own
    (``python3 -m zultra_tpu_torch.kernel_bench <family>``): on the H100 a
    torch.profiler trace taken late in a process holds no device events
    more and more often (8 of 8 traces of a 20-ms call held its kernels
    60 s into a process, 0 or 1 of 8 after 110 s; longer calls first), and
    the families take minutes, much of it the plain forms on the host.
    The recorded compression here gives the program keys and launches the
    golden phase checks. -> ({kernel: result}, the program keys the
    recorded run met or captured)."""
    g.tables  # the match program's first call of the gzip windows' shape
    seen_before = set(programs.device_programs(g.dev).seen)
    captured_before = captured_keys(g.dev)
    g.run  # the programs' eager first calls; captures the match program met above
    gzip_keys = ((set(programs.device_programs(g.dev).seen) - seen_before)
                 | (captured_keys(g.dev) - captured_before))
    results = {}
    for family in kernel_bench.FAMILIES:
        done = subprocess.run([sys.executable, "-m", "zultra_tpu_torch.kernel_bench", family],
                              cwd=REPO, capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"kernel_bench {family}: exit {done.returncode}\n"
                             f"{done.stderr[-4000:]}")
        for kernel, res in json.loads(done.stdout.splitlines()[-1])["kernels"].items():
            for row in res["rows"]:
                print(row_text(kernel, row))
            totals = {k: v for k, v in res.items() if k.startswith(("run_", "launch_floor_"))}
            if totals:
                print(f"{kernel} over the run: {totals}")
            results[kernel] = res
    return results, gzip_keys


def golden_phase(cases, dev, eager_counts, gzip_keys) -> tuple:
    """Every golden case one-shot. -> ({case: launches}, the gzip run's
    programs and their pool's bytes)."""
    first = {}
    captured_golden = captured_keys(dev)
    for name, (case, d, dictionary) in cases.items():
        out, first[name] = checked_run(name, case, d, dictionary,
                                       lambda: one_shot(case, d, dictionary, dev))
        print(f"one-shot {name}: {len(d)} B -> {len(out)} B, equal to the golden digest, "
              f"decodes; launches {first[name]}")
        if name != "gzip":
            continue
        # The gzip run captured the programs of the shapes the recorded run
        # met (the kernel phase's calls come between), no other, and it
        # launched what that eager run launched.
        counts = launch_counts()
        if counts != eager_counts:
            raise SystemExit(f"programs: the capturing gzip run launched {counts}, the "
                             f"eager first run {eager_counts}")
        captured_now = captured_keys(dev)
        if not gzip_keys <= captured_now or (captured_now - captured_golden) - gzip_keys:
            raise SystemExit("programs: the gzip shapes are not all captured, or the gzip "
                             "run captured others")
        gzip_graphs = ([p for p in programs.captured(dev) if p["key"] in gzip_keys],
                       programs.pool_bytes(dev))
    return first, gzip_graphs


def programs_phase(dev, smi, gzip_keys, gzip_graphs, eager_counts) -> None:
    """Every program captured so far (the gzip run's, then those of the
    other cases that met a shape twice), replayed on the inputs of its
    last call with set_sync_debug_mode("error") around the replay,
    against an eager call of its function on the same inputs."""
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
    gzip_programs, gzip_pool = gzip_graphs
    print(f"programs: the gzip run captured {len(gzip_programs)} graphs, pool {gzip_pool} B; "
          f"{len(rows)} graphs after every golden case, pool {programs.pool_bytes(dev)} B, "
          f"peak reserved {torch.cuda.max_memory_reserved()} B; the capturing gzip run's "
          f"launches equal the eager first run's ({eager_counts}); on {smi}")


def staircase_check(g, smi) -> None:
    """The staircase on the gzip case's segments at compress_sharded's
    64 KiB cores against the walk, and ms a segment of each by events: at
    the program's batch (replays) and at 32 segments a call (an eager call
    of the program's function), beside the walk on the same segments at
    each batch and on all of them in one call (as the match program walks
    a batch), with and without its suffix arrays."""
    dev = g.dev
    core = staircase_torch.STAIRCASE_CORE
    segbufs, _ = matchfinder_torch.build_segments(g.corpus, g.spans, core)
    seg_dev = torch.from_numpy(segbufs).to(dev)
    stats0 = dict(staircase_torch.FALLBACK_STATS)
    st_rows = staircase_torch.sharded_rows(segbufs, [dev], 16, core)
    n_seg = staircase_torch.FALLBACK_STATS["segments"] - stats0["segments"]
    n_over = staircase_torch.FALLBACK_STATS["overflowed"] - stats0["overflowed"]
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
    for label, got, want in zip(("lengths", "offsets", "overflow"), (lens_s, offs_s, over_s),
                                cpu_two):
        compare(f"staircase on the card against its CPU run ({label})", got[:2], want)
    per_seg = {
        ("staircase", batch): events_ms(lambda: staircase_torch.staircase_segments(
            seg_dev[:batch], 16, HALO, core), 3) / batch,
        ("staircase", 32): events_ms(lambda: staircase_torch.staircase_program(
            seg_dev[:32], budget_factor=16, core_off=HALO, core_len=core), 3) / 32}
    for b in (batch, 32, len(segbufs)):
        salcp = matchfinder_torch.salcp_batch(seg_dev[:b])
        per_seg["walk", b] = events_ms(lambda: walk_cuda.walk_segments(salcp, HALO, core), 3) / b
        per_seg["walk with suffix arrays", b] = events_ms(lambda: walk_cuda.walk_segments(
            matchfinder_torch.salcp_batch(seg_dev[:b]), HALO, core), 3) / b
    print(f"staircase: gzip case, {n_seg} segments of {segbufs.shape[1]} words ({core} core), "
          f"{n_over} overflowed; rows equal to the walk's on every segment that does not "
          f"overflow and to its CPU run on two; ms a segment (events), by segments a call: "
          + "; ".join(f"{k} at {b} {v:.4f}" for (k, b), v in per_seg.items())
          + "; ratio staircase / walk with suffix arrays " + ", ".join(
              f"{per_seg['staircase', b] / per_seg['walk with suffix arrays', b]:.2f} at {b}"
              for b in (batch, 32)) + f"; on {smi}")


def sharded_phase(g, cases, first, gzip_keys, smi) -> None:
    """The staircase, compress_sharded, optimize_matches; then a gzip
    one-shot run that replays its graphs. Each compression runs with the
    counts set to 0 just before."""
    dev = g.dev
    torch.cuda.reset_peak_memory_stats()
    staircase_check(g, smi)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    sharded_kernels = tuple(k for k in COMPRESS_KERNELS if k != "walk")
    for name in ("gzip", "dictionary"):
        case, d, dictionary = cases[name]
        for devs in (["cuda:0"], ["cuda:0", "cuda:0"]):
            for _ in range(2):  # a first call, then a replay of its programs
                reset_launch_counts()
                out = compress_sharded(d, devs, case["flags"], case["block_size"],
                                       dictionary=dictionary)
                torch.cuda.synchronize()
                got_counts = path_counts(f"sharded {name}", launch_counts(), sharded_kernels)
                check_output(f"sharded {name} {devs}", case, d, dictionary, out)
            print(f"compress_sharded {name} {devs}: {len(d)} B equal to the golden digest, "
                  f"decodes, first call and replay; launches {got_counts}")

    data = g.data
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

    window = g.corpus[: HALO + (1 << 20)]
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
    held = captured_keys(dev)
    staircase_keys = [p["text"] for p in programs.captured(dev)
                      if p["key"][0] is staircase_torch.staircase_program]
    print(f"programs after the sharded phase: {len(held)} graphs, the staircase's "
          f"{staircase_keys}; the gzip run's {len(gzip_keys & held)} of "
          f"{len(gzip_keys)} still captured")
    case = cases["gzip"][0]
    _, got_counts = checked_run("gzip after the sharded phase", case, data, None,
                                lambda: one_shot(case, data, None, dev))
    if got_counts != first["gzip"] or captured_keys(dev) != held or not gzip_keys <= held:
        raise SystemExit("programs: the gzip one-shot after the sharded phase did not replay "
                         "its graphs")
    print(f"one-shot gzip after the sharded phase: replayed its graphs, captured none; "
          f"launches {got_counts}")


def stream_cli_phase(cases, first, dev) -> None:
    """``Stream`` fed the CLI's 16 KiB chunks, twice a case, then one-shot
    again; the CLI's ``-c``, ``-cbench`` and ``-quicktest``."""
    def streamed(case, d):
        stream = Stream(case["flags"], case["block_size"], device=dev)
        pieces = [stream.compress(d[i : i + cli.CHUNK_SIZE])
                  for i in range(0, len(d), cli.CHUNK_SIZE)]
        pieces.append(stream.compress(b"", FINALIZE))
        return b"".join(pieces)

    for name in ("gzip", "stream"):
        case, d, _ = cases[name]
        runs = [checked_run(f"stream {name}", case, d, None, lambda: streamed(case, d))
                for _ in range(2)]
        _, again = checked_run(name, case, d, None, lambda: one_shot(case, d, None, dev))
        if again != first[name]:
            raise SystemExit(f"programs: a later {name} run launched {again}, its capturing "
                             f"run {first[name]}")
        print(f"stream {name}: {len(d)} B in {cli.CHUNK_SIZE} B chunks, twice, equal to the "
              f"golden digest, decodes; launches stream {runs[0][1]} one-shot {first[name]}")

    case, d, _ = cases["deflate"]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.deflate"
        src.write_bytes(d)
        for mode, argv in (("-c", ["-deflate", "-c", str(src), str(dst)]),
                           ("-cbench", ["-deflate", "-cbench", str(src)]),
                           ("-quicktest", ["-quicktest"])):
            reset_launch_counts()
            rc = cli.main(argv, device=dev)
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"cli {mode}: exit code {rc}")
            got_counts = path_counts(f"cli {mode}", launch_counts())
            if mode == "-c":
                check_output("cli -c", case, d, None, dst.read_bytes())
            print(f"cli {mode}: exit 0"
                  f"{', output equal to the deflate digest' if mode == '-c' else ''}; "
                  f"launches {got_counts}")


def per_window(case, d, dictionary, dev) -> bytes:
    """Every window planned alone through the engine's per-window
    contract, emitted in stream order, framed as compress_device."""
    engine = DeviceWindowEngine(dev)
    mbs = clamp_block_size(case["block_size"])
    flags = case["flags"]
    dict_b = dictionary or b""
    corpus = np.frombuffer(dict_b + d, np.uint8)
    base = len(dict_b)
    out = bytearray(frame.encode_header(flags, dictionary))
    buf = bytearray(memory_bound(mbs, flags, mbs))
    bits_data = bits_count = 0
    spans = [(base + lo, base + min(lo + mbs, len(d))) for lo in range(0, len(d), mbs)]
    for i, (lo, hi) in enumerate(spans):
        prev = min(32768, lo)
        handle = engine.begin_window(corpus[lo - prev : hi], prev, hi - lo)
        n_out, bits_data, bits_count = engine.emit_window(
            handle, i + 1 == len(spans), buf, bits_data, bits_count)
        engine.free_window(handle)
        out += buf[:n_out]
    out += frame.encode_footer(flags, frame.update_checksum(
        frame.init_checksum(flags), corpus[base:], flags), len(d))
    return bytes(out)


def windows_phase(cases, dev) -> None:
    """The many-window, device and process paths. Each of the first three
    runs three times: its first run meets the shapes of its own programs
    (a batch of another width) eagerly, the second captures them, the
    third replays them."""
    def thrice(label, case, d, dictionary, fn):
        return [checked_run(label, case, d, dictionary, fn) for _ in range(3)][2][1]

    case, d, dictionary = cases["zlib"]
    got_counts = thrice("per-window zlib", case, d, dictionary,
                        lambda: per_window(case, d, dictionary, dev))
    for _ in range(2):  # the one-shot's shapes met above: a capturing run, then a replay
        checked_run("zlib", case, d, dictionary, lambda: one_shot(case, d, dictionary, dev))
    n_windows = -(-len(d) // clamp_block_size(case["block_size"]))
    print(f"per-window zlib: {n_windows} windows of {case['block_size']} B each planned alone "
          f"(begin_window + emit_window), equal to the golden digest, decodes; launches "
          f"{got_counts}")

    case, d, _ = cases["stream"]
    for wpb in (2, 5):
        got_counts = thrice(
            f"windows_per_batch {wpb}", case, d, None,
            lambda: compress_device(d, case["flags"], case["block_size"], windows_per_batch=wpb,
                                    device=dev))
        print(f"windows_per_batch {wpb}: stream case ({len(d)} B, 33 windows) equal to the golden "
              f"digest, decodes; launches {got_counts}")

    case, d, _ = cases["gzip"]
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n_cards)] if n_cards > 1 else ["cuda:0", "cuda:0"]
    got_counts = thrice(
        "devices", case, d, None,
        lambda: compress_device(d, case["flags"], case["block_size"], devices=devices))
    print(f"devices {devices}: gzip case equal to the golden digest, decodes; launches "
          f"{got_counts}")

    out, rank_stats = multihost.run_windows_distributed(
        d, case["flags"], case["block_size"], world_size=2, device="cuda:0", timeout=600)
    check_output("distributed gzip", case, d, None, out)
    got_counts = path_counts("distributed gzip", {
        k: sum(st["launches"][k] for st in rank_stats) for k in KERNELS})
    print(f"distributed gzip: 2 gloo ranks on cuda:0 (spawned), rank 0's stream equal to the "
          f"golden digest, decodes; launches (both ranks) {got_counts}")


def statistics_check(g) -> int:
    """Corpus statistics of the 4 MiB corpus at 64 KiB windows (64
    windows, no padding) and the checksums, against torch.bincount and
    zlib. -> the histogram kernel's launches."""
    data, dev = g.data, g.dev
    reset_launch_counts()
    stats = sharded_corpus_stats(data, devices=[dev])
    torch.cuda.synchronize()
    launches = path_counts("corpus statistics", launch_counts(), ("hist",))["hist"]
    windows = g.corpus_dev.view(stats["n_windows"], -1)
    if not torch.equal(torch.from_numpy(stats["corpus_histogram"]),
                       torch.bincount(g.corpus_dev, minlength=256).cpu()):
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
        "adler32 on the card": checksum.adler32(g.corpus, device=dev) == zlib.adler32(data),
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
          f"torch.bincount, suffix arrays consistent with their ranks; hist launches "
          f"{launches}; checksums equal to zlib: {sorted(checks)}")
    return launches


def write_tokens_check(emitted: dict, dev) -> None:
    """write_tokens on the first block of the gzip case's first planner
    bucket: its chosen parse and codes, against the planner's own words."""
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
    got = write_tokens(window, best, 0, L, lit, off, device=dev)
    got_counts = path_counts("write_tokens", launch_counts(), ("chain",))
    plain = write_tokens(window, best, 0, L, lit, off, device="cpu")
    if got[1] != want_bits or got[0] != want.tobytes() or got != plain:
        raise SystemExit(f"write_tokens: {got[1]} bits against the plan's {want_bits}, or bytes "
                         "not equal to the plan's words or to the plain form")
    print(f"write_tokens: one block of {L} B of the gzip plan, {got[1]} bits equal to the "
          f"plan's total_bits, bytes equal to its words and to the plain form (cpu); "
          f"launches {got_counts}")


def kernel_table(results: dict, launches: dict) -> list:
    """The JSON rows of every kernel: its source, what it replaces, its
    launches in the gzip one-shot run, its representative row's numbers
    and all of its rows."""
    kernels = []
    for name, (source, replaces) in {**KERNELS, **OFF_PATH_KERNELS}.items():
        r = results[name]
        extra = {} if name in KERNELS else {"path": "no path runs it"}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches.get(name, 0), "bound_by": "bytes",
                        "library_ms": r.get("library_ms"), **extra, **r})
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to smoke-test", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = build_phase()
    cases = kernel_bench.golden()
    g = kernel_bench.Gzip(dev, cases)
    results, gzip_keys = kernel_phase(g)
    eager_counts = g.run.launches
    first, gzip_graphs = golden_phase(cases, dev, eager_counts, gzip_keys)
    programs_phase(dev, smi, gzip_keys, gzip_graphs, eager_counts)
    sharded_phase(g, cases, first, gzip_keys, smi)
    stream_cli_phase(cases, first, dev)
    windows_phase(cases, dev)
    launches = dict(first["gzip"], hist=statistics_check(g))
    write_tokens_check(g.run.emitted, dev)
    print(json.dumps({"kernels": kernel_table(results, launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
