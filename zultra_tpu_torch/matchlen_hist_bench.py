"""Times the matchlen and byte-histogram kernels on one CUDA card, on the
rows chip_smoke.py holds them against their plain forms.

    python3 -m zultra_tpu_torch.matchlen_hist_bench [--only matchlen|hist]

Matchlen rows: the corpus match pairs (the pair (i, i - offset) of every
position of the 4 MiB gzip case of smoke_golden.json whose first match
row has length >= 3) and the smoke's edge batch (the first 1 MiB with a
300-byte run: pos == prev, spans near and past the end, random pairs).
Histogram rows: the 4 MiB corpus, the corpus from byte 1 (unaligned),
64 MiB of seeded random bytes and 64 MiB of one byte value. Then each
kernel's launch floor: one pair over 16 bytes, and one byte. For every
row: milliseconds per call by CUDA events over back-to-back wrapper
calls (the result checked against the plain form first) and device
milliseconds per call from a torch.profiler trace; for the histogram
rows also the device time of all of a call's kernels (a wrapper that
zeroes or copies launches more than its kernel) and ``torch.bincount``'s
(events, and all of its device kernels).
It prints the corpus pairs' length distribution (the share of lengths
<= 8, 16, 32, 64 and = 258). It calls ``match_lengths`` and
``byte_histogram`` only, so it runs on any tree of this package (copy it
into an older tree's ``zultra_tpu_torch/`` to time that tree's kernels).
``--only`` times one kernel's rows. Prints the card's name and power
limit first and one JSON object last; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .corpus import case_inputs
from .ops import histogram_cuda, matchlen_cuda
from .ops.matchfinder_torch import HALO, match_tables_device_stacked

GOLDEN = Path(__file__).resolve().parent / "smoke_golden.json"


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


def trace_ms(fn, kernel, reps: int = 20):
    """Mean device milliseconds per call spent in the CUDA kernels
    ``{kernel}_kernel`` and ``{kernel}_{phase}_kernel`` (or an
    instance of such a template), each launched once a call
    (torch.profiler trace of ``reps`` calls after one warm-up; each
    kernel's time averaged over the launches the trace recorded, as a
    trace may drop some; a trace that recorded none is taken again, up
    to three times), without the host time of the wrapper around them;
    with kernel None, all device activity of the calls over ``reps``;
    None when no trace holds such a kernel."""
    name = re.compile(rf"::{kernel}(?:_[a-z]+)?_kernel(?:<[^>]*>)?\(") if kernel else None
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if ev.count and (
            name.search(ev.key) if name else ev.device_type == torch.autograd.DeviceType.CUDA)]
        if name:
            us = sum(ev.self_device_time_total / ev.count for ev in evs)
        else:
            us = sum(ev.self_device_time_total for ev in evs) / reps
        if us:
            return us / 1e3
    return None


def match_pairs(corpus: np.ndarray, lens: torch.Tensor, offs: torch.Tensor, mbs: int):
    """(pos, prev) int32 on the card: the pair (i, i - offset) of every
    position of the corpus whose first match row has length >= 3, from
    the match tables of its windows of ``mbs`` bytes."""
    dev = lens.device
    at = (torch.arange(0, len(corpus), mbs, device=dev)[:, None]
          + torch.arange(mbs, device=dev)[None, :])
    has = (lens[:, HALO:, 0] >= 3) & (at < len(corpus))
    return (at[has].to(torch.int32).contiguous(),
            (at - offs[:, HALO:, 0])[has].to(torch.int32).contiguous())


def corpus_pairs(dev):
    """(corpus on the card, pos, prev) of the gzip case's match pairs, as
    chip_smoke.py builds them."""
    case = next(c for c in json.loads(GOLDEN.read_text())["cases"] if c["name"] == "gzip")
    corpus = np.frombuffer(case_inputs(case)[0], np.uint8)
    mbs = 1 << 20
    spans = [(lo, min(lo + mbs, len(corpus))) for lo in range(0, len(corpus), mbs)]
    lens, offs = match_tables_device_stacked(corpus, spans, mbs, dev)
    return (torch.from_numpy(corpus.copy()).to(dev), *match_pairs(corpus, lens, offs, mbs))


def edge_batch(corpus: np.ndarray, dev):
    """A seeded edge batch on a copy of the corpus's first 1 MiB with a
    300-byte run: pos == prev, spans near and past the end, the run,
    random pairs."""
    edge = corpus[: 1 << 20].copy()
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
    return (torch.from_numpy(edge).to(dev), torch.from_numpy(pos.astype(np.int32)).to(dev),
            torch.from_numpy(prev.astype(np.int32)).to(dev))


def length_shares(lengths: torch.Tensor) -> dict:
    n = max(lengths.numel(), 1)
    shares = {f"le_{k}": int((lengths <= k).sum()) / n for k in (8, 16, 32, 64)}
    shares["eq_258"] = int((lengths == 258).sum()) / n
    shares["mean"] = float(lengths.float().mean()) if lengths.numel() else 0.0
    return shares


def row(label, fn, plain, kernel, reps, extra=None) -> dict:
    got = fn()
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), plain.cpu()):
        raise SystemExit(f"{kernel} [{label}]: the kernel differs from its plain form")
    r = {"kernel": kernel, "row": label, "ms": events_ms(fn, reps),
         "device_ms": trace_ms(fn, kernel), **(extra or {})}
    print(json.dumps(r))
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("matchlen", "hist"))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    corpus, pos, prev = corpus_pairs(dev)
    rows = []
    shares = None
    ml_inputs = {}
    if opts.only != "hist":
        zeros = torch.zeros(16, dtype=torch.uint8, device=dev)
        one_pair = torch.zeros(1, dtype=torch.int32, device=dev)
        ml_inputs = {"corpus match pairs": (corpus, pos, prev),
                     "edge batch": edge_batch(corpus.cpu().numpy(), dev),
                     "launch floor": (zeros, one_pair, one_pair)}
    for label, args in ml_inputs.items():
        plain = matchlen_cuda.match_lengths_plain(*args)
        if label == "corpus match pairs":
            shares = length_shares(plain)
            print(f"corpus pairs: {pos.numel()}, lengths {shares}")
        rows.append(row(label, lambda a=args: matchlen_cuda.match_lengths(*a), plain, "matchlen",
                        10, {"pairs": int(args[1].numel())}))

    big = torch.from_numpy(np.random.default_rng(4).integers(0, 256, 64 << 20, np.uint8)).to(dev)
    one = torch.full((64 << 20,), 211, dtype=torch.uint8, device=dev)
    hist_inputs = {} if opts.only == "matchlen" else {
        "4 MiB corpus": corpus, "corpus[1:] (unaligned)": corpus[1:], "64 MiB seeded": big,
        "64 MiB one value": one, "launch floor": corpus[:1]}
    for label, x in hist_inputs.items():
        plain = histogram_cuda.byte_histogram_plain(x, 256)
        lib = {"library_ms": events_ms(lambda x=x: torch.bincount(x, minlength=256), 20),
               "library_device_ms": trace_ms(lambda x=x: torch.bincount(x, minlength=256), None),
               "n": int(x.numel())}
        lib["call_device_ms"] = trace_ms(lambda x=x: histogram_cuda.byte_histogram(x, 256), None)
        rows.append(row(label, lambda x=x: histogram_cuda.byte_histogram(x, 256), plain, "hist",
                        20, lib))
    print(json.dumps({"card": smi, "corpus_pair_lengths": shares, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
