"""The port's CUDA kernels held against their plain forms and timed on one
card, a family at a time, at the shapes the main path gives them.

    python3 -m zultra_tpu_torch.kernel_bench <family> [--sweep]

A family's function (``FAMILIES``) builds its inputs, compares every
output of its kernels with their plain forms (it stops on any difference)
and returns {kernel: result}: the kernel's representative row with all of
its ``rows``. A row holds the max abs err against the plain form, the ms a
call by CUDA events (``events_ms``), the device ms from a torch.profiler
trace (``device_ms``: a call's and each kernel's a launch), the plain
form's ms and the byte bound (``bound_ms``). The inputs come from the
4 MiB gzip case of smoke_golden.json (``Gzip``: its four 1 MiB windows'
match tables, and one compression of it with the planner's and splitter's
calls recorded by shape) and from seeded edge cases. ``chip_smoke.py``
runs every family; the command line runs one (with ``--sweep``, the walk
also at each chunk size of ``WALK_SWEEP``) and prints the card's name and
power limit, then one JSON line. Needs a CUDA device: exits 2 without one.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .corpus import case_inputs, mixed_corpus, text_corpus
from .device_pipeline import compress_device
from .ops import (block_torch, chain_cuda, dp_cuda, entropy_torch, histogram_cuda,
                  launch_counts, matchlen_cuda, mk_cuda, plan_cuda, prefix_cuda,
                  reset_launch_counts, rle_cuda, split_torch, suffix_cuda, suffix_torch,
                  walk_cuda)
from .ops import matchfinder_torch as mt
from .ops.entropy_torch import build_lengths, kraft_inputs, mask_histograms, mk_inputs, mk_lengths

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
GOLDEN = Path(__file__).resolve().parent / "smoke_golden.json"
MBS = 1 << 20  # the gzip case's block size: four windows in one device batch
TRACE_TRIES = 10  # traces of one measurement at most: a trace may drop device events
# The trace names of each kernel's launches (``kernel_pattern``).
PATTERNS = {"walk": "walk", "dp": "dp", "chain": "chain", "mk12": "mk12", "kraft": "kraft",
            "suffix_round": "suffix_round|rank_scatter", "matchlen": "matchlen", "hist": "hist",
            "rle_sweep": "rle_sweep", "rle_stats": "rle_stats", "prefix_tables": "prefix_tables",
            "prep_lanes": "prep_lanes", "token_hist": "token_hist", "emit_tokens": "emit_tokens",
            "lex_order": "lex_order"}
ZEROING = re.compile(r"(?i)memset|fillfunctor")  # a memset, or torch's fill kernel
WALK_SWEEP = [1024, 2048, 4096, 8192, 32768]
PARTIAL_CORE = 20423  # a walk core that is no multiple of any chunk size
DOUBLING_STORE = 8  # stored levels, as the match program keeps them
DOUBLING_SHAPES = [("mixed, 16 x 1 MiB", "mixed", 16, 1 << 20),
                   ("text, 16 x 2 MiB", "text", 16, 2 << 20),
                   ("text, 1 x 48,944 B", "text", 1, 48944)]


# -- timers and bounds -------------------------------------------------------

def events_ms(fn, reps: int, parts: int = 0):
    """Milliseconds a call of ``fn`` by CUDA events, after one warm-up
    call: the mean over ``reps`` back-to-back calls. With ``parts``,
    ``fn(mark)`` calls ``mark()`` after each of its ``parts`` parts, and
    the result is the list of each part's median over ``reps`` calls."""
    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    if not parts:
        fn()
        start, end = events(2)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    fn(lambda: None)
    times = []
    for _ in range(reps):
        ev = events(parts + 1)
        marks = iter(ev[1:])
        ev[0].record()
        fn(lambda: next(marks).record())
        torch.cuda.synchronize()
        times.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    return [statistics.median(col) for col in zip(*times)]


def kernel_pattern(prefix: str) -> re.Pattern:
    """The trace names of the port's kernels ``{prefix}_kernel`` and
    ``{prefix}_{phase}_kernel``, bare, in a namespace or as a template's
    instance; group 1 is the kernel's name. ``prefix`` may hold
    alternatives (``a|b``)."""
    return re.compile(rf"(?<!\w)((?:{prefix})(?:_\w+?)?_kernel)(?!\w)")


def kernel_name(key: str, pattern) -> str | None:
    """The name ``device_ms`` files the trace's op ``key`` under, None
    when it does not match: for a prefix (str) the kernel's name, for a
    regex its first group or else the key, for None (every op) the key."""
    if pattern is None:
        return key
    if isinstance(pattern, str):
        pattern = kernel_pattern(pattern)
    m = pattern.search(key)
    return None if m is None else (m.group(1) if pattern.groups else key)


def device_ms(fn, pattern, reps: int = 20, per_call: bool = False) -> dict:
    """{name: device ms} of the device ops of ``reps`` calls of ``fn``
    that ``pattern`` matches (``kernel_name``), from a torch.profiler
    trace after one warm-up call: a launch's mean, or with ``per_call``
    their sum a call. The inputs are fixed, so each op runs as often in
    every call: a trace that matched no op, or holds a name whose count
    is no multiple of ``reps``, dropped events and is taken again, up to
    ``TRACE_TRIES`` times; the last that matched any is read. {} when
    none did."""
    from torch.profiler import ProfilerActivity, profile

    if isinstance(pattern, str):
        pattern = kernel_pattern(pattern)
    found = {}
    for _ in range(TRACE_TRIES):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, count = defaultdict(float), defaultdict(int)
        for ev in prof.key_averages():
            if ev.count and ev.device_type == torch.autograd.DeviceType.CUDA:
                name = kernel_name(ev.key, pattern)
                if name:
                    us[name] += ev.self_device_time_total
                    count[name] += ev.count
        if us:
            found = {k: us[k] / (reps if per_call else count[k]) / 1e3 for k in us}
            if all(c % reps == 0 for c in count.values()):
                break
    return found


def host_ms(fn) -> tuple:
    """(fn(), its milliseconds by the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n: int) -> float:
    """Milliseconds to move ``n`` bytes at the card's memory rate (the
    kernels do no tensor-core work)."""
    return n / HBM_BYTES_PER_S * 1e3


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Max abs err of ``got`` against ``want``: 0, else it stops."""
    torch.cuda.synchronize()
    got = got.cpu().to(torch.int64)
    want = want.cpu().to(torch.int64)
    if got.shape != want.shape:
        raise SystemExit(f"{name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    if err != 0:
        raise SystemExit(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def kernel_row(name, label, kernel, plain, args, reps, *, plain_on="cuda", plain_reps=1,
               need=None, library=None, library_name=None, later=None, **extra) -> dict:
    """``kernel(*args)`` timed and held against ``plain(*args)``: a row.
    The plain form runs on the card, timed by events over ``plain_reps``
    calls, or with ``plain_on`` "cpu" on host copies by the host clock.
    The bound counts the bytes ``need(args, outputs)`` gives, else every
    input and output once; ``library`` is a PyTorch call of the same
    function, timed by events beside it. With ``later`` (a list) the
    plain form and the comparison are appended to it as one call, for the
    family to make after its traces: plain forms that take minutes would
    push the traces late into the process (``chip_smoke.kernel_phase``)."""
    got = kernel(*args)
    outs = got if isinstance(got, tuple) else (got,)
    tensors = [a for a in args if torch.is_tensor(a)]
    launches = device_ms(lambda: kernel(*args), PATTERNS[name], reps)
    row = dict(batch=label, shape=[list(a.shape) for a in tensors],
               ms=events_ms(lambda: kernel(*args), reps),
               device_ms=sum(launches.values()) if launches else None,
               launch_device_ms=launches, plain_device=plain_on,
               bound_ms=bound_ms(nbytes(*tensors, *outs) if need is None else need(args, outs)),
               **extra)
    if library is not None:
        row["library_ms"] = events_ms(library, 3)
        row["library"] = library_name

    def check():
        if plain_on == "cpu":
            want, row["plain_ms"] = host_ms(lambda: plain(*(a.cpu() if torch.is_tensor(a) else a
                                                            for a in args)))
        else:
            want, row["plain_ms"] = plain(*args), events_ms(lambda: plain(*args), plain_reps)
        wants = want if isinstance(want, tuple) else (want,)
        row["max_abs_err"] = max(compare(f"{name} [{label}]", g, w) for g, w in zip(outs, wants))

    if later is None:
        check()
    else:
        later.append(check)
    return row


def result(rows: list, representative=None, **extra) -> dict:
    """A kernel's result: its representative row (the first by default)
    with every row under ``rows``."""
    return dict(representative or rows[0], rows=rows, **extra)


def largest(rows: list) -> dict:
    """The row of the most bytes, which stands for its kernel."""
    return max(rows, key=lambda r: r["bound_ms"])


def over_run(run, name: str, rows: list, keys: list) -> dict:
    """The calls of the recorded run at each of its shapes (rows[i] is
    shape keys[i]) and the sum of each shape's bound times its calls."""
    for row, key in zip(rows, keys):
        row["run_calls"] = run.calls[name][key]
    return dict(run_calls=sum(run.calls[name].values()), run_launches=run.launches[name],
                run_bound_ms=sum(r["run_calls"] * r["bound_ms"] for r in rows[:len(keys)]))


# -- the inputs --------------------------------------------------------------

def golden() -> dict:
    """{name: (case, input, dictionary or None)} of every case of
    smoke_golden.json, each input rebuilt from its recipe
    (``corpus.case_inputs``) and held against its recorded sha256."""
    cases = {}
    for case in json.loads(GOLDEN.read_text())["cases"]:
        data, dictionary = case_inputs(case)
        if hashlib.sha256(data).hexdigest() != case["input_sha256"]:
            raise SystemExit(f"{case['name']}: the rebuilt input differs from the recorded one "
                             "(numpy's generator on this machine), not a fault of the port")
        cases[case["name"]] = (case, data, dictionary)
    return cases


class Gzip:
    """The 4 MiB gzip case on a card and what the rows are cut from, each
    part made on its first use and kept: its four windows' match tables,
    the tables of single seeded lanes, and one recorded compression."""

    def __init__(self, dev, cases: dict | None = None):
        self.dev = torch.device(dev)
        self.case, self.data, _ = (cases or golden())["gzip"]
        self.corpus = np.frombuffer(self.data, np.uint8)
        self.spans = [(lo, min(lo + MBS, len(self.data))) for lo in range(0, len(self.data), MBS)]
        self._lanes = {}

    @functools.cached_property
    def tables(self):
        """(lens, offs) of the four windows, as the one-shot path stacks them."""
        return mt.match_tables_device_stacked(self.corpus, self.spans, MBS, self.dev)

    @functools.cached_property
    def corpus_dev(self) -> torch.Tensor:
        return torch.from_numpy(self.corpus.copy()).to(self.dev)

    @functools.cached_property
    def run(self) -> SimpleNamespace:
        return record_run(self)

    def lane(self, label: str, buf: np.ndarray):
        """(lens, offs) of ``buf`` as one window of its own length; one
        match program call for each label."""
        if label not in self._lanes:
            self._lanes[label] = mt.match_tables_device_stacked(buf, [(0, len(buf))], len(buf),
                                                                self.dev)
        return self._lanes[label]


def _clone(*args):
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


# (module, attribute) -> (kernel, the shape key of a call, what to keep of
# its first call of a shape from (output, *arguments)).
HOOKS = {
    (block_torch, "run_dp"): ("dp", lambda *a: a[2].shape[1], lambda out, *a: a),
    (block_torch, "chain_marks"): ("chain", lambda *a: a[0].shape[1], lambda out, *a: a),
    (block_torch, "token_hist"): (
        "token_hist", lambda w, ln, of, length, tok=None: (tuple(w.shape), tok is not None),
        lambda out, w, ln, of, length, tok=None: (w, ln, of, out[2])),  # views
    (block_torch, "emit_tokens"): ("emit_tokens", lambda *a: tuple(a[0].shape),
                                   lambda out, *a: a),
    (block_torch, "optimize_for_rle_pair"): (
        "rle_sweep", lambda lit, off: (*lit.shape, off.shape[1]), lambda out, *a: _clone(*a)),
    (entropy_torch, "rle_histogram_tables"): (
        "rle_stats", lambda lit, off, m: ("histogram", lit.shape[0], len(m)),
        lambda out, lit, off, m: (*_clone(lit, off), tuple(m))),
    (entropy_torch, "rle_bits_tables"): (
        "rle_stats", lambda lit, off, te, m: ("bits", lit.shape[0], len(m)),
        lambda out, lit, off, te, m: (*_clone(lit, off, te), tuple(m))),
    (split_torch, "prefix_tables"): ("prefix_tables", lambda *a: tuple(a[0].shape),
                                     lambda out, *a: _clone(*a)),
    (entropy_torch, "_lex_order"): ("lex_order", lambda k: tuple(k.shape),
                                    lambda out, k: _clone(k)),
    (mk_cuda, "mk_phase12"): ("mk12", lambda a0, n: tuple(a0.shape), lambda out, *a: _clone(*a)),
    (mk_cuda, "kraft_limit"): ("kraft", lambda lens, n, k0, m: (*lens.shape, m),
                               lambda out, *a: _clone(*a)),
}


def record_run(g: Gzip) -> SimpleNamespace:
    """One compression of the gzip case with the calls of ``HOOKS``
    recorded: ``args`` {kernel: {shape key: what its first call keeps}},
    ``calls`` {kernel: {key: calls}}, ``launches`` the run's launch
    counts, ``emitted`` the first planner bucket's lane lengths and its
    emission's arguments and output. A process's first call of a
    program's shape runs eagerly (``ops/programs.py``); the hooks record
    those calls alone, since a capture's tensors hold nothing until a
    replay and a copy made in a capture would join the graph. They wrap
    functions the programs call, never a program's own function, whose
    identity keys it."""
    rec = SimpleNamespace(args=defaultdict(dict), calls=defaultdict(lambda: defaultdict(int)),
                          emitted={})

    def hook(kernel, key_of, keep, real):
        def wrapper(*args):
            out = real(*args)
            if not torch.cuda.is_current_stream_capturing():
                key = key_of(*args)
                rec.calls[kernel][key] += 1
                if key not in rec.args[kernel]:
                    rec.args[kernel][key] = keep(out, *args)
                if kernel == "token_hist":
                    rec.emitted.setdefault("length", args[3].clone())
                elif kernel == "emit_tokens":
                    rec.emitted.setdefault("args", args)
                    rec.emitted.setdefault("out", out)
            return out
        return wrapper

    real = {target: getattr(*target) for target in HOOKS}
    for target, (kernel, key_of, keep) in HOOKS.items():
        setattr(*target, hook(kernel, key_of, keep, real[target]))
    try:
        reset_launch_counts()
        compress_device(g.data, g.case["flags"], g.case["block_size"], device=g.dev)
        torch.cuda.synchronize()
        rec.launches = launch_counts()
    finally:
        for target, fn in real.items():
            setattr(*target, fn)
    return rec


# -- the walk ----------------------------------------------------------------

def walk_segments(g: Gzip) -> dict:
    """label -> (salcp (S, n) int32, halo, core_len): the 128 segments of
    the gzip case as the one-shot path cuts its windows (the main path's
    call), single segments of a zero run, a period-3 run and seeded
    random bytes, and the 64th gzip segment over a partial core."""
    segbufs, _ = mt.build_segments(g.corpus, g.spans, mt.SEG_CORE)
    gzip = mt.salcp_batch(torch.from_numpy(segbufs).to(g.dev))
    n = mt.SEG_LEN

    def one(buf):
        return mt.salcp_batch(torch.from_numpy(buf.astype(np.int32)[None]).to(g.dev))

    return {
        f"gzip {len(segbufs)} segments": (gzip, mt.HALO, mt.SEG_CORE),
        "zero run": (one(np.zeros(n)), mt.HALO, mt.SEG_CORE),
        "period 3": (one(np.resize(np.array([7, 7, 9]), n)), mt.HALO, mt.SEG_CORE),
        "random bytes": (one(np.random.default_rng(9).integers(0, 256, n)), mt.HALO,
                         mt.SEG_CORE),
        f"partial core {PARTIAL_CORE}": (gzip[64:65].contiguous(), mt.HALO, PARTIAL_CORE),
    }


def walk(g: Gzip, sweep: bool = False) -> dict:
    """The walk on ``walk_segments`` against the plain walk on the host;
    with ``sweep`` also each chunk size of ``WALK_SWEEP`` (rows equal to
    the default's; its scratch bytes and a 16-window batch's)."""
    rows = []
    batch = 16 * (MBS // mt.SEG_CORE)
    for label, (salcp, halo, core) in walk_segments(g).items():
        S, n = salcp.shape
        row = kernel_row("walk", label, lambda s: walk_cuda.walk_segments(s, halo, core),
                         lambda s: walk_cuda.walk_segments_plain(s, halo, core), (salcp,), 3,
                         plain_on="cpu", core_len=core, chunk=walk_cuda.CHUNK,
                         scratch_bytes=walk_cuda.scratch_bytes(S, n, core))
        if sweep:
            want = walk_cuda.walk_segments(salcp, halo, core)
            row["sweep"] = []
            for chunk in WALK_SWEEP:
                def call():
                    return walk_cuda.walk_segments(salcp, halo, core, chunk)

                compare(f"walk [{label}] chunk {chunk}", call(), want)
                launches = device_ms(call, PATTERNS["walk"], 3)
                row["sweep"].append(dict(
                    chunk=chunk, ms=events_ms(call, 3),
                    device_ms=sum(launches.values()) if launches else None,
                    launch_device_ms=launches,
                    scratch_bytes=walk_cuda.scratch_bytes(S, n, core, chunk),
                    batch_scratch_bytes=walk_cuda.scratch_bytes(batch, n, mt.SEG_CORE, chunk)))
        rows.append(row)
    return {"walk": result(rows)}


# -- the chain and the DP ----------------------------------------------------

def _i32(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=dev)


def _greedy_steps(lens: torch.Tensor) -> torch.Tensor:
    rl = lens[:, :, 0]
    return torch.where(rl >= 3, rl, 1).to(torch.int32).contiguous()


def chain(g: Gzip) -> dict:
    """The chain on the splitter's four 2^21 lanes (greedy row-0 steps,
    start HALO), every planner bucket of the run (its first pass), a 2^21
    lane of 3s (two thirds of the segments cannot merge) and a 64 KiB
    zero run, against pointer doubling on the host; with the segments the
    kernel anchored, re-walked (merging) and left unmerged."""
    W, nz, n3 = len(g.spans), 1 << 16, 1 << 21
    split = _greedy_steps(g.tables[0])
    split = torch.nn.functional.pad(
        split, (0, split_torch.split_bucket(mt.HALO + MBS) - split.shape[1]), value=1)
    zero = _greedy_steps(g.lane("64 KiB zero run", np.zeros(nz, np.uint8))[0])
    lanes = {
        f"splitter {W} x 2^21": (split.contiguous(), _i32([mt.HALO] * W, g.dev),
                                 _i32([mt.HALO + hi - lo for lo, hi in g.spans], g.dev)),
        **{f"gzip bucket {k}": args for k, args in sorted(g.run.args["chain"].items())},
        "all-3 2^21": (torch.full((1, n3), 3, dtype=torch.int32, device=g.dev),
                       _i32([0], g.dev), _i32([n3], g.dev)),
        "zero run 64 KiB": (zero[:, mt.HALO : mt.HALO + nz].contiguous(), _i32([0], g.dev),
                            _i32([nz], g.dev)),
    }
    rows = []
    for label, args in lanes.items():
        st = chain_cuda.chain_marks(*args, status=True)[1]
        live = st[st != chain_cuda.ST_NONE]
        counts = {k: int((live == getattr(chain_cuda, f"ST_{k.upper()}")).sum())
                  for k in ("exact", "anchored", "rerun", "unmerged")}
        rows.append(kernel_row(
            "chain", label, chain_cuda.chain_marks, chain_cuda.chain_marks_plain, args, 3,
            plain_on="cpu", lengths=args[2].tolist()[:16], segments=int(live.numel()), **counts,
            rewalk_share=(counts["rerun"] + counts["unmerged"])
            / max(1, int(live.numel()) - counts["exact"])))
    return {"chain": result(rows)}


def dp_lane(g: Gzip, label: str, buf: np.ndarray) -> tuple:
    """The DP's arguments for ``buf`` planned as one lane of its own
    length, with the greedy histograms' code lengths."""
    n = len(buf)
    lens, offs = g.lane(label, buf)
    win = torch.from_numpy(buf.copy()).to(g.dev)[None]
    ml = lens[:, mt.HALO : mt.HALO + n].contiguous()
    mo = offs[:, mt.HALO : mt.HALO + n].contiguous()
    length = _i32([n], g.dev)
    g_lit, g_off, _ = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    return (*dp_cuda.prep_lanes(build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo,
                                length), length)


def dp(g: Gzip) -> dict:
    """The DP against its sequential plain form on the host, with the
    share of segments its fix-up re-ran: eight 32 KiB corpus lanes, every
    planner bucket of the run (its first pass), a 64 KiB zero run (no
    segment anchors), and two lanes of 2^21 positions (a 2 MiB block, the
    longest), text and random bytes."""
    lens, offs = g.tables
    n = 32768
    lanes = [(w, mt.HALO + j * n) for w in range(len(g.spans)) for j in range(2)][:8]
    win = torch.stack([torch.from_numpy(g.corpus[g.spans[w][0] + s - mt.HALO:][:n].copy())
                       for w, s in lanes]).to(g.dev)
    ml = torch.stack([lens[w, s : s + n] for w, s in lanes]).contiguous()
    mo = torch.stack([offs[w, s : s + n] for w, s in lanes]).contiguous()
    length = torch.full((len(lanes),), n, dtype=torch.int32, device=g.dev)
    g_lit, g_off, _ = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    calls = [("8 x 32768 corpus lanes", (*dp_cuda.prep_lanes(
        build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo, length), length), 3)]
    calls += [(f"gzip bucket {n_pad}", (*dp_cuda.prep_lanes(*args), args[5]), 3)
              for n_pad, args in sorted(g.run.args["dp"].items())]
    calls += [("64 KiB zero run", dp_lane(g, "64 KiB zero run", np.zeros(1 << 16, np.uint8)), 3),
              ("2^21 text", dp_lane(g, "2^21 text", np.frombuffer(text_corpus(1 << 21, 6),
                                                                  np.uint8)), 1),
              ("2^21 random bytes", dp_lane(g, "2^21 random bytes", np.random.default_rng(
                  6).integers(0, 256, 1 << 21, np.uint8)), 1)]
    rows, checks = [], []  # the plain forms, 2.5 minutes on the host, after every trace
    for label, args, reps in calls:
        st = dp_cuda.dp_choices(*args, status=True)[1]
        seg = st[st != dp_cuda.ST_NONE]
        rerun = int((seg == dp_cuda.ST_RERUN).sum())
        rows.append(kernel_row(
            "dp", label, dp_cuda.dp_choices, lambda *a: dp_cuda.dp_choices_plain(*a[:4]), args,
            reps, plain_on="cpu", later=checks, lengths=args[4].tolist()[:16],
            segments=int(seg.numel()), rerun=rerun, fixed_share=rerun / max(1, int(seg.numel()))))
    for check in checks:
        check()
    return {"dp": result(rows)}


# -- the doubling round ------------------------------------------------------

def doubling_batch(content: str, W: int, mbs: int, dev) -> torch.Tensor:
    """A device batch of W windows of ``mbs`` bytes (content seed 0), cut
    into segments as the match program cuts them."""
    make = mixed_corpus if content == "mixed" else text_corpus
    corpus = np.frombuffer(make(W * mbs, seed=0), np.uint8)
    spans = [(i * mbs, (i + 1) * mbs) for i in range(W)]
    corpus_dev, meta, W, k = mt.upload_batch(corpus, spans, mbs, dev)
    return mt.segments_from_corpus(corpus_dev, meta[: W * k], mt.SEG_LEN)


def plain_rounds(bufs: torch.Tensor):
    """Every round by ``suffix_torch._round``: (sa, stored ranks, each
    round's flags)."""
    rank = bufs.to(torch.int32)
    rows, flags, sa = [rank], [], None
    for level in range(suffix_torch.num_levels(bufs.shape[1])):
        sa, rank, distinct = suffix_torch._round(rank, 1 << level)
        if level < DOUBLING_STORE:
            rows.append(rank)
        flags.append(distinct)
    return sa, torch.stack(rows), flags


def kernel_rounds(bufs: torch.Tensor, mark=lambda: None):
    """``doubling_rounds_fixed``'s rounds one by one, ``mark()`` after
    each: (sa, stored ranks, rounds each segment ran)."""
    st, ranks = None, torch.empty((DOUBLING_STORE + 1, *bufs.shape), dtype=torch.int32,
                                  device=bufs.device)
    ranks[0] = bufs
    for level in range(suffix_torch.num_levels(bufs.shape[1])):
        if level < DOUBLING_STORE:
            out = ranks[level + 1]
            st = suffix_torch._step(st, ranks[level], level, out)
            if st.rank is not out:  # the plain round's new tensor
                out.copy_(st.rank)
        else:
            out = st.rank if level > DOUBLING_STORE else torch.empty_like(st.rank)
            st = suffix_torch._step(st, st.rank, level, out)
        mark()
    return st.sa, ranks, st.run


def suffix(g: Gzip) -> dict:
    """The doubling at ``DOUBLING_SHAPES``: the kernel's rounds (8 stored)
    against the plain rounds on the card (the suffix order, the stored
    ranks, the rounds each segment ran). By events: the first round alone
    (it also sorts the symbols), each round of the doubling, those that
    run and those every segment skips, a skip in place and one that
    copies its ranks (a stored level), both doublings whole; beside them
    a plain round and ``torch.sort`` of one round's packed keys, which the
    port calls on none of these rows. The bound: 16 B a position a
    round."""
    rows = []
    for label, content, W, mbs in DOUBLING_SHAPES:
        bufs = doubling_batch(content, W, mbs, g.dev)
        S, n = bufs.shape
        levels = suffix_torch.num_levels(n)
        got = kernel_rounds(bufs)
        sa_p, ranks_p, flags = plain_rounds(bufs)
        flags = torch.stack(flags)
        first = torch.where(flags.any(0), flags.to(torch.int32).argmax(0) + 1, levels)
        err = max(compare(f"suffix_round [{label}] sa", got[0], sa_p),
                  compare(f"suffix_round [{label}] ranks", got[1], ranks_p),
                  compare(f"suffix_round [{label}] rounds run", got[2], first))
        per_round = events_ms(lambda mark: kernel_rounds(bufs, mark), 3, parts=levels)
        ran = int(got[2].max())
        state = suffix_cuda.new_state(S, n, g.dev)
        symbols, out = bufs.to(torch.int32), torch.empty_like(ranks_p[0])
        done, _ = suffix_torch.stored_rounds(bufs, DOUBLING_STORE)
        done = suffix_torch.later_rounds(done, DOUBLING_STORE)
        copy_to = torch.empty_like(done.rank)
        keys = ranks_p[1].to(torch.int64) * (n + 257) + 1

        def first_round():
            suffix_cuda.launch_round(symbols, out, state, 1, True)

        launches = device_ms(first_round, PATTERNS["suffix_round"], 3)
        rows.append(dict(
            batch=label, shape=[S, n], max_abs_err=err, rounds=levels, rounds_run=ran,
            ms=events_ms(first_round, 3), device_ms=sum(launches.values()) if launches else None,
            launch_device_ms=launches, round_ms=per_round,
            run_round_ms=statistics.mean(per_round[1:ran]) if ran > 1 else None,
            skip_ms=events_ms(lambda: suffix_cuda.launch_round(
                done.rank, done.rank, done.state, 1 << (levels - 1), False), 5),
            skip_copy_ms=events_ms(lambda: suffix_cuda.launch_round(
                done.rank, copy_to, done.state, 1 << (DOUBLING_STORE - 1), False), 5),
            doubling_ms=events_ms(lambda: kernel_rounds(bufs), 3),
            plain_doubling_ms=events_ms(lambda: plain_rounds(bufs), 1),
            plain_ms=events_ms(lambda: suffix_torch._round(ranks_p[1], 2), 3),
            plain_device="cuda", library="torch.sort(stable=True)",
            library_ms=events_ms(lambda: torch.sort(keys, dim=1, stable=True), 3),
            bound_ms=bound_ms(16 * S * n)))
        del bufs, got, sa_p, ranks_p, state, symbols, out, done, copy_to, keys
        torch.cuda.empty_cache()
    return {"suffix_round": result(rows)}


# -- MK and Kraft ------------------------------------------------------------

def mk(g: Gzip) -> dict:
    """MK and Kraft at the main path's shapes. Histograms are the greedy
    token histograms of the corpus cut into lanes: 4096 lanes of 1 KiB
    (the splitter's batch for four 1 MiB windows), 40 lanes of 64 KiB (40
    is no multiple of 32) and the planner's own widths, 1, 4 and 84 lanes
    of 32 KiB, at S = 288, 32 and the CL alphabet's 19; a skewed batch
    (weights 2^0..2^20) that Kraft must repair; a misaligned copy of a
    batch in each MK layout (4 bytes past a 16-byte boundary); edge lanes
    (all weights equal, n_used 0, 1, 2, 3 and S); the launch floor (one
    lane of 2 symbols); and the first call of every shape of the run,
    with its calls there."""
    lens, offs = g.tables
    run = g.run

    def lane_hists(n_lanes, lane_len):
        lw = torch.from_numpy(g.corpus[: n_lanes * lane_len].copy()).to(g.dev).view(
            n_lanes, lane_len)
        lr = lens[:, mt.HALO:, 0].reshape(-1, lane_len)[:n_lanes].contiguous()
        lo = offs[:, mt.HALO:, 0].reshape(-1, lane_len)[:n_lanes].contiguous()
        return block_torch.token_hist(lw, lr, lo, _i32([lane_len] * n_lanes, g.dev))[:2]

    def edge_hists(B, S):
        erng = np.random.default_rng(S)
        h = np.zeros((B, S), np.int32)
        for b in range(B):
            if b % 6 == 0:
                h[b] = 9
            else:
                used = (0, 1, 2, 3, S)[b % 6 - 1]
                h[b, erng.permutation(S)[:used]] = erng.integers(1, 1000, used)
        return torch.from_numpy(h).to(g.dev)

    def misaligned(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=g.dev)[1:]
        return buf.view(x.shape).copy_(x)

    def mk_row(label, args, misalign=False):
        if misalign:
            args = (misaligned(args[0]), *args[1:])
        return kernel_row("mk12", label, mk_cuda.mk_phase12, mk_cuda.mk_phase12_plain, args, 20,
                          layout=("thread per lane" if args[0].shape[0] > mk_cuda.WARP_LANES
                                  else "warp per lane"), base_mod_16=args[0].data_ptr() % 16)

    def kraft_row(label, args, misalign=False):
        lens_in, n_used, kraft0, max_len = args
        if misalign:
            lens_in = misaligned(lens_in)
        return kernel_row(
            "kraft", label, lambda *a: mk_cuda.kraft_limit(*a, max_len),
            lambda *a: mk_cuda.kraft_limit_plain(*a, max_len), (lens_in, n_used, kraft0), 20,
            max_len=max_len, repair_lanes=int((kraft0 > (1 << max_len)).sum()),
            fit_lanes=int((kraft0 == (1 << max_len)).sum()))

    def mk_args(h):
        return mk_inputs(h)[:2]

    def kraft_args(h, max_len):
        return (*kraft_inputs(mk_lengths(h), max_len)[:3], max_len)

    split_lit, split_off = lane_hists(4096, 1024)
    plan_lit, plan_off = lane_hists(40, 65536)
    cl_hists = mask_histograms(build_lengths(plan_lit, 15), build_lengths(plan_off, 15))[0]
    small_lit, small_off = lane_hists(84, 32768)
    small_cl = mask_histograms(build_lengths(small_lit, 15), build_lengths(small_off, 15))[0]
    rng = np.random.default_rng(0)
    skewed = torch.from_numpy((2 ** rng.integers(0, 21, (4096, 288))).astype(np.int32)).to(g.dev)

    mk_rows = [mk_row(label, mk_args(h)) for label, h in (
        ("splitter 288", split_lit), ("splitter 32", split_off), ("planner 288", plan_lit),
        ("planner 32", plan_off), ("mask search 19", cl_hists))]
    kraft_rows = [kraft_row(label, kraft_args(h, max_len)) for label, h, max_len in (
        ("planner 288", plan_lit, 15), ("planner 32", plan_off, 15),
        ("mask search 19", cl_hists, 7), ("skewed 288", skewed, 15))]
    if kraft_rows[-1]["repair_lanes"] == 0:
        raise SystemExit("kraft: the skewed batch has no lane that needs the repair")
    for B in (1, 4, 84):
        for S, h, max_len in ((288, small_lit, 15), (32, small_off, 15), (19, small_cl, 7)):
            mk_rows.append(mk_row(f"path {B} x {S}", mk_args(h[:B])))
            kraft_rows.append(kraft_row(f"path {B} x {S}", kraft_args(h[:B], max_len)))
    for label, h in (("misaligned splitter 288", split_lit), ("misaligned 84 x 288", small_lit)):
        mk_rows.append(mk_row(label, mk_args(h), misalign=True))
    for label, h in (("misaligned skewed 288", skewed), ("misaligned 84 x 288", small_lit)):
        kraft_rows.append(kraft_row(label, kraft_args(h, 15), misalign=True))
    for S in (19, 32, 288):
        for B in (6, 600):
            mk_rows.append(mk_row(f"edge lanes {B} x {S}", mk_args(edge_hists(B, S))))
            for max_len in (7, 15):
                kraft_rows.append(kraft_row(f"edge lanes {B} x {S}",
                                            kraft_args(edge_hists(B, S), max_len)))
    one, two = torch.ones((1, 2), dtype=torch.int32, device=g.dev), _i32([2], g.dev)
    mk_rows.append(mk_row("launch floor 1 x 2", (one, two)))
    kraft_rows.append(kraft_row("launch floor 1 x 2", (one, two, _i32([1 << 15], g.dev), 15)))
    res = {}
    for name, rows, row_of in (("mk12", mk_rows, mk_row), ("kraft", kraft_rows, kraft_row)):
        keys = sorted(run.args[name])
        run_rows = [row_of(f"gzip run {' x '.join(map(str, key))}", run.args[name][key])
                    for key in keys]
        totals = over_run(run, name, run_rows, keys)
        totals["run_device_ms"] = sum(r["run_calls"] * (r["device_ms"] or 0.0) for r in run_rows)
        res[name] = result(rows + run_rows, **totals)
    return res


# -- the planner's and splitter's scans and fused passes ---------------------

def rle(g: Gzip) -> dict:
    """The RLE sweep on the planner's pair call (both histogram sets in
    one launch) at every lane count of the run, and on each set alone; the
    RLE statistics at every shape of the run in both modes (the mask
    search's 20 masks a launch, the dynamic costs' one), from the code
    lengths themselves, beside the plain form (the concatenation, then the
    statistics a mask) and the launch floor (one lane, n_def 0)."""
    run = g.run

    def sweep_plain(lit, off):
        return rle_cuda.optimize_for_rle_plain(lit), rle_cuda.optimize_for_rle_plain(off)

    sweep_keys = sorted(run.args["rle_sweep"], reverse=True)
    sweep_rows = [kernel_row("rle_sweep", f"planner pair {B} x {La} + {B} x {Lb}",
                             rle_cuda.optimize_for_rle_pair, sweep_plain,
                             run.args["rle_sweep"][B, La, Lb], 20)
                  for B, La, Lb in sweep_keys]
    sweep_totals = over_run(run, "rle_sweep", sweep_rows, sweep_keys)
    sweep_rows += [kernel_row("rle_sweep", f"one set {tuple(rows.shape)}",
                              rle_cuda.optimize_for_rle, rle_cuda.optimize_for_rle_plain,
                              (rows,), 20)
                   for key in sweep_keys for rows in run.args["rle_sweep"][key]]

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

    stats_keys = sorted(run.args["rle_stats"], key=lambda k: (-k[2], -k[1], k[0]))
    stats_rows = [kernel_row("rle_stats", f"{mode}, {B} lanes x {M} masks", stats_kernel,
                             stats_plain, run.args["rle_stats"][mode, B, M], 20)
                  for mode, B, M in stats_keys]
    floor_lens = torch.zeros((1, 19), dtype=torch.int32, device=g.dev)
    floor_nd = torch.zeros(1, dtype=torch.int32, device=g.dev)
    floor = device_ms(lambda: rle_cuda.rle_histogram_masks(floor_lens, floor_nd, (7,)),
                      PATTERNS["rle_stats"], 50)
    return {"rle_sweep": result(sweep_rows, **sweep_totals),
            "rle_stats": result(stats_rows, launch_floor_device_ms=sum(floor.values()) or None,
                                **over_run(run, "rle_stats", stats_rows, stats_keys))}


def prefix(g: Gzip) -> dict:
    """The prefix tables on the splitter's tokens of the run and on a
    seeded lane of one 64 KiB window (a fifth of its positions tokens, as
    the gzip run has), beside ``torch.cumsum`` of their (W, n, 18)
    one-hot along the tokens (P18's part; the one-hot built beforehand).
    The bound counts three int32 rows of the tokens below n_tok and the
    outputs."""
    run = g.run
    trng = np.random.default_rng(11)
    window = [torch.from_numpy(a.astype(np.int32)).to(g.dev) for a in (
        trng.integers(0, 18, (1, 1 << 16)), trng.integers(0, 286, (1, 1 << 16)),
        np.where(trng.random((1, 1 << 16)) < 0.4, trng.integers(288, 318, (1, 1 << 16)), 320),
        np.array([13107]))]
    keys = sorted(run.args["prefix_tables"], reverse=True)
    calls = [(f"splitter {W} x {n}", run.args["prefix_tables"][W, n]) for W, n in keys]

    def need(args, outs):
        return 12 * int(args[3].clamp(0, args[0].shape[1]).sum()) + nbytes(args[3], *outs)

    rows = []
    for label, args in calls + [("one window 1 x 65536", window)]:
        n = args[0].shape[1]
        onehot = ((args[0][:, :, None] == torch.arange(18, dtype=torch.int32, device=g.dev))
                  & (torch.arange(n, device=g.dev)[None, :] < args[3][:, None])[:, :, None]
                  ).to(torch.int32)
        rows.append(kernel_row(
            "prefix_tables", label, prefix_cuda.prefix_tables, prefix_cuda.prefix_tables_plain,
            args, 10, need=need, library=lambda: torch.cumsum(onehot, dim=1, dtype=torch.int32),
            library_name="torch.cumsum", n_tok=args[3].tolist()))
        del onehot
    return {"prefix_tables": result(rows, **over_run(run, "prefix_tables", rows, keys))}


def emit_edge_calls(buckets: dict) -> dict:
    """{label: emission args} at the edges of its tiling, cut from the
    run's own calls ({shape: args}): a lane of length 0 (no mark) at the
    widest bucket's width, a lane of literals alone at the one-lane
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


def plan(g: Gzip) -> dict:
    """The planner's fused passes at the run's shapes, each against its
    plain form on the card: the DP's lane preparation on every bucket's
    first pass; the token histograms of every bucket (the greedy call,
    whose lengths and offsets are the match tables' first row, a view of
    stride 8, and a convergence pass) and of the lanes that hammer one bin
    (``plan_cuda.hammer_lanes``); the emission of every bucket and at the
    edges of its tiling (``emit_edge_calls``), a call's device time its
    kernel's and its memset's, beside a ``torch.zeros`` of its words; and
    the (key, index) order of every row shape the planner and splitter
    sorted, of rows of one repeated key and of 1024 keys, beside
    ``torch.sort(stable=True)``. The histograms' and the emission's bounds
    count what the marks need: every mark, a marked position's length, a
    match's offset, a literal's byte (and the code tables, the words and
    totals)."""
    run, dev = g.run, g.dev
    prep_rows = [kernel_row("prep_lanes", f"gzip bucket {tuple(args[2].shape)}",
                            dp_cuda.prep_lanes, dp_cuda.prep_lanes_plain, args, 5)
                 for _, args in sorted(run.args["dp"].items())]

    def hist_kernel(w, ln, of, tok):
        return block_torch.token_hist(w, ln, of, None, tok)[:2]

    def hist_need(args, outs):
        _, lens, _, is_tok = args
        match = is_tok & (lens >= 3)
        return (is_tok.numel() + 4 * int(is_tok.sum()) + 4 * int(match.sum())
                + int((is_tok & ~match).sum()) + nbytes(*outs))

    hist_keys = sorted(run.args["token_hist"])
    hist_rows = [kernel_row(
        "token_hist", f"{'given marks' if given else 'chain marks'} {shape}", hist_kernel,
        block_torch.token_hist_plain, run.args["token_hist"][shape, given], 5, need=hist_need)
        for shape, given in hist_keys]
    hist_totals = over_run(run, "token_hist", hist_rows, hist_keys)
    h_win, h_lens, h_offs, h_len = plan_cuda.hammer_lanes(131072, dev)
    h_marks = chain_cuda.chain_marks(torch.where(h_lens[:, :, 0] >= 3, h_lens[:, :, 0], 1),
                                     torch.zeros_like(h_len), h_len)
    for lane, what in enumerate(("zero-run lane", "one-byte lane")):
        sl = slice(lane, lane + 1)
        for label, ln, of in (("", h_lens[sl, :, 0].contiguous(), h_offs[sl, :, 0].contiguous()),
                              (", stride 8", h_lens[sl, :, 0], h_offs[sl, :, 0])):
            hist_rows.append(kernel_row("token_hist", f"{what} (1, 131072){label}", hist_kernel,
                                        block_torch.token_hist_plain,
                                        (h_win[sl], ln, of, h_marks[sl]), 5, need=hist_need))

    def emit_need(args, outs):
        win, lens, offs, *tables, is_tok = args
        return hist_need((win, lens, offs, is_tok), outs) + nbytes(*tables)

    emit_keys = sorted(run.args["emit_tokens"])
    emit_calls = [(f"gzip bucket {shape}", run.args["emit_tokens"][shape]) for shape in emit_keys]
    emit_calls += list(emit_edge_calls(run.args["emit_tokens"]).items())
    emit_rows = []
    for label, args in emit_calls:
        row = kernel_row("emit_tokens", label, block_torch.emit_tokens,
                         block_torch.emit_tokens_plain, args, 5, need=emit_need)
        words = block_torch.emit_tokens(*args)[0]
        row["memset_device_ms"] = sum(device_ms(lambda: block_torch.emit_tokens(*args), ZEROING,
                                                per_call=True).values()) or None
        if row["device_ms"] is None or row["memset_device_ms"] is None:
            raise SystemExit(f"emit_tokens [{label}]: a trace of its calls holds no kernel "
                             "or no memset")
        row["call_device_ms"] = row["device_ms"] + row["memset_device_ms"]
        row["bound_share"] = row["bound_ms"] / row["call_device_ms"]
        row["zeros_device_ms"] = sum(device_ms(
            lambda: torch.zeros(words.shape, dtype=words.dtype, device=dev), ZEROING,
            per_call=True).values()) or None
        emit_rows.append(row)
    emit_totals = over_run(run, "emit_tokens", emit_rows, emit_keys)
    emit_totals["run_device_ms"] = {
        k: sum(r["run_calls"] * (r[k] or 0.0) for r in emit_rows[:len(emit_keys)])
        for k in ("device_ms", "memset_device_ms", "call_device_ms", "zeros_device_ms")}

    lex_keys = sorted(run.args["lex_order"], reverse=True)
    lex_calls = [(f"{B} rows x {S}", run.args["lex_order"][B, S][0]) for B, S in lex_keys]
    lex_rng = np.random.default_rng(16)
    lex_calls += [(f"all-equal {B} rows x 288",
                   torch.full((B, 288), 5, dtype=torch.int32, device=dev)) for B in (4096, 1)]
    lex_calls += [(f"1024 keys, {B} rows", torch.from_numpy(
        lex_rng.integers(-50, 50, (B, 1024)).astype(np.int32)).to(dev)) for B in (128, 1)]
    lex_rows = [kernel_row("lex_order", label, entropy_torch._lex_order,
                           entropy_torch._lex_order_plain, (key,), 20,
                           library=lambda key=key: torch.sort(key, dim=1, stable=True),
                           library_name="torch.sort(stable=True)",
                           layout=plan_cuda.lex_order_layout(*key.shape))
                for label, key in lex_calls]
    return {"prep_lanes": result(prep_rows, largest(prep_rows)),
            "token_hist": result(hist_rows, largest(hist_rows), **hist_totals),
            "emit_tokens": result(emit_rows, largest(emit_rows), **emit_totals),
            "lex_order": result(lex_rows, largest(lex_rows),
                                **over_run(run, "lex_order", lex_rows, lex_keys))}


# -- the two kernels no path runs: matchlen, the byte histogram ---------------

def match_pairs(g: Gzip):
    """(pos, prev) int32 on the card: the pair (i, i - offset) of every
    position of the corpus whose first match row has length >= 3."""
    lens, offs = g.tables
    at = (torch.arange(0, len(g.corpus), MBS, device=g.dev)[:, None]
          + torch.arange(MBS, device=g.dev)[None, :])
    has = (lens[:, mt.HALO:, 0] >= 3) & (at < len(g.corpus))
    return (at[has].to(torch.int32).contiguous(),
            (at - offs[:, mt.HALO:, 0])[has].to(torch.int32).contiguous())


def edge_batch(g: Gzip):
    """A seeded edge batch on a copy of the corpus's first 1 MiB with a
    300-byte run: pos == prev, spans near and past the end, the run,
    random pairs."""
    edge = g.corpus[:MBS].copy()
    run_at = 500_000
    edge[run_at : run_at + 300] = 7
    n_e = len(edge)
    rng = np.random.default_rng(3)
    same = rng.integers(0, n_e, 4000)
    tail = rng.integers(n_e - 258, n_e, 4000)
    pos = np.concatenate([same, tail, n_e + rng.integers(0, 50, 100), [n_e - 1, n_e],
                          run_at + 1 + np.arange(299), rng.integers(0, n_e, 4000)])
    prev = np.concatenate([same, tail - rng.integers(1, 2000, 4000), rng.integers(0, n_e, 100),
                           [n_e - 2, 0], run_at + np.arange(299), rng.integers(0, n_e, 4000)])
    return (torch.from_numpy(edge).to(g.dev), torch.from_numpy(pos.astype(np.int32)).to(g.dev),
            torch.from_numpy(prev.astype(np.int32)).to(g.dev))


def matchlen(g: Gzip) -> dict:
    """Matchlen on the corpus's match pairs (with the share of their
    lengths at most 8, 16, 32 and 64 bytes and at 258, which set
    ``matchlen_cuda.HEAD``), the edge batch, ``matchlen_cuda.edge_pairs``
    (every p, q mod 16, lengths around each head width, 258 and the cap,
    spans to the end, bad indices) with the data at every base offset
    0-15, ending at the end of its buffer, and the launch floor (one pair
    over 16 bytes)."""
    p_data, p_pos, p_prev = matchlen_cuda.edge_pairs()
    planted = [torch.empty(off + len(p_data), dtype=torch.uint8, device=g.dev)[off:]
               for off in range(16)]
    for x in planted:
        x.copy_(torch.from_numpy(p_data))
    p_pos, p_prev = torch.from_numpy(p_pos).to(g.dev), torch.from_numpy(p_prev).to(g.dev)
    pair = torch.zeros(1, dtype=torch.int32, device=g.dev)
    rows = []
    for label, args in (("corpus match pairs", (g.corpus_dev, *match_pairs(g))),
                        ("edge batch", edge_batch(g)),
                        ("edge pairs, base offsets 0-15", (planted[0], p_pos, p_prev)),
                        ("launch floor", (torch.zeros(16, dtype=torch.uint8, device=g.dev),
                                          pair, pair))):
        row = kernel_row("matchlen", label, matchlen_cuda.match_lengths,
                         matchlen_cuda.match_lengths_plain, args, 10,
                         pairs=int(args[1].numel()), head=matchlen_cuda.HEAD)
        got = matchlen_cuda.match_lengths(*args)
        row["n_258"] = int((got == 258).sum())
        if label.startswith("edge pairs"):
            for off, x in enumerate(planted[1:], 1):
                compare(f"matchlen at base offset {off}",
                        matchlen_cuda.match_lengths(x, p_pos, p_prev), got)
        elif label == "corpus match pairs":
            row["length_shares"] = {
                **{f"le_{k}": int((got <= k).sum()) / max(got.numel(), 1) for k in (8, 16, 32, 64)},
                "eq_258": row["n_258"] / max(got.numel(), 1)}
        rows.append(row)
    if rows[1]["n_258"] < 1 or rows[2]["n_258"] < 1:
        raise SystemExit("matchlen: an edge batch has no pair at the 258 cap")
    return {"matchlen": result(rows)}


def hist(g: Gzip) -> dict:
    """The byte histogram on the 4 MiB corpus (n_symbols 256 and 200, and
    an unaligned view), 64 MiB of seeded bytes (past the TPU kernel's
    2^24-byte chunk), 64 MiB of one value (every count on one bin) and one
    byte (the launch floor), against its plain form and
    ``torch.bincount``, with the device time of the kernel, of all of a
    call's device ops and of bincount's."""
    big = torch.from_numpy(np.random.default_rng(4).integers(0, 256, 64 << 20, np.uint8)
                           ).to(g.dev)
    one = torch.full((64 << 20,), 211, dtype=torch.uint8, device=g.dev)
    corpus = g.corpus_dev
    rows = []
    for label, x, n_sym in (("4 MiB corpus", corpus, 256), ("4 MiB corpus", corpus, 200),
                            ("corpus[1:] (unaligned)", corpus[1:], 256),
                            ("64 MiB seeded", big, 256), ("64 MiB one value", one, 256),
                            ("launch floor", corpus[:1], 256)):
        def call(x=x, n_sym=n_sym):
            return histogram_cuda.byte_histogram(x, n_sym)

        def library(x=x):
            return torch.bincount(x, minlength=256)

        row = kernel_row("hist", label, lambda x: histogram_cuda.byte_histogram(x, n_sym),
                         lambda x: histogram_cuda.byte_histogram_plain(x, n_sym), (x,), 20,
                         plain_reps=5, library=library, library_name="torch.bincount",
                         n=int(x.numel()), n_symbols=n_sym)
        compare(f"hist [{label}] against torch.bincount", call(), library()[:n_sym])
        row["call_device_ms"] = sum(device_ms(call, None, 20, per_call=True).values())
        row["library_device_ms"] = sum(device_ms(library, None, 20, per_call=True).values())
        rows.append(row)
    return {"hist": result(rows)}


FAMILIES = {"dp": dp, "chain": chain, "walk": walk, "suffix": suffix, "mk": mk, "rle": rle,
            "prefix": prefix, "plan": plan, "matchlen": matchlen, "hist": hist}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("family", choices=FAMILIES)
    ap.add_argument("--sweep", action="store_true",
                    help="the walk family: also each chunk size of WALK_SWEEP")
    args = ap.parse_args(argv)
    if args.sweep and args.family != "walk":
        ap.error("--sweep is the walk family's")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi)
    g = Gzip("cuda")
    kernels = walk(g, args.sweep) if args.family == "walk" else FAMILIES[args.family](g)
    print(json.dumps({"card": smi, "family": args.family, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
