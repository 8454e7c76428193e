"""Smoke run of zultra_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from csrc/ (nvcc, sm_90a), holds each kernel
against its plain PyTorch version at the shapes the one-shot path gives
it, compresses a seeded 4 MiB mixed corpus (four 1 MiB windows in one
device batch) with the port and with zultra_tpu's native engine
(the byte oracle on a machine without JAX), and checks the bytes, the
zlib decode and that the one-shot run went through all three kernels.
Prints one line per phase, a JSON line of kernel results, and, last,
{"ok": true, "device": {...}}. Exits non-zero on any failure, and
before printing any result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

KERNELS = {
    "walk": ("zultra_tpu_torch/csrc/walk.cu", "zultra_tpu/ops/walk_pallas.py:78"),
    "dp": ("zultra_tpu_torch/csrc/dp.cu", "zultra_tpu/ops/dp_pallas.py:69"),
    "chain": ("zultra_tpu_torch/csrc/chain.cu", "zultra_tpu/ops/chain_pallas.py:41"),
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


def host_ms(fn) -> tuple:
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    torch.cuda.synchronize()
    got = got.cpu().to(torch.int64)
    want = want.to(torch.int64)
    if got.shape != want.shape:
        raise SystemExit(f"{name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    if err != 0:
        raise SystemExit(f"{name}: kernel disagrees with its plain version (max abs err {err})")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to smoke-test", file=sys.stderr)
        return 2
    import zultra_tpu as zt
    from zultra_tpu import engine
    from zultra_tpu_torch import _build, compress_device
    from zultra_tpu_torch.corpus import mixed_corpus
    from zultra_tpu_torch.ops import block_torch, chain_cuda, dp_cuda, walk_cuda
    from zultra_tpu_torch.ops.entropy_torch import build_lengths
    from zultra_tpu_torch.ops.matchfinder_torch import (
        HALO,
        SEG_CORE,
        build_segments,
        match_tables_device_stacked,
        salcp_batch,
    )
    from zultra_tpu_torch.ops.split_torch import split_bucket

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"card: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")

    # -- phase 3: each kernel against its plain version ----------------
    data = mixed_corpus(4 << 20, seed=args.seed)
    corpus = np.frombuffer(data, np.uint8)
    mbs = 1 << 20
    spans = [(lo, min(lo + mbs, len(data))) for lo in range(0, len(data), mbs)]
    results = {}

    segbufs, _ = build_segments(corpus, spans, SEG_CORE)
    salcp_all = salcp_batch(torch.from_numpy(segbufs).to(dev))
    one = salcp_all[len(segbufs) // 2 :][:1].contiguous()
    got = walk_cuda.walk_segments(one, HALO, SEG_CORE)
    want, plain = host_ms(lambda: walk_cuda.walk_segments_plain(one.cpu(), HALO, SEG_CORE))
    results["walk"] = dict(
        max_abs_err=compare("walk", got, want), plain_ms=plain,
        ms=cuda_ms(lambda: walk_cuda.walk_segments(one, HALO, SEG_CORE), 3),
        main_path_ms=cuda_ms(lambda: walk_cuda.walk_segments(salcp_all, HALO, SEG_CORE), 2))
    print(f"walk: equal on one segment {tuple(one.shape)}; kernel {results['walk']['ms']:.2f} ms, "
          f"plain {plain:.1f} ms; all {len(segbufs)} segments {results['walk']['main_path_ms']:.2f} ms")

    lens, offs = match_tables_device_stacked(corpus, spans, mbs, dev)
    n = 32768
    W = len(spans)
    lanes = [(w, HALO + j * n) for w in range(W) for j in range(2)][:8]
    win = torch.stack([torch.from_numpy(corpus[spans[w][0] + s - HALO:][:n].copy())
                       for w, s in lanes]).to(dev)
    ml = torch.stack([lens[w, s : s + n] for w, s in lanes]).contiguous()
    mo = torch.stack([offs[w, s : s + n] for w, s in lanes]).contiguous()
    length = torch.full((len(lanes),), n, dtype=torch.int32, device=dev)
    g_lit, g_off, _ = block_torch.token_hist(win, ml[:, :, 0], mo[:, :, 0], length)
    dp_in = dp_cuda.prep_lanes(build_lengths(g_lit, 15), build_lengths(g_off, 15), win, ml, mo,
                               length)
    got = dp_cuda.dp_choices(*dp_in)
    want, plain = host_ms(lambda: dp_cuda.dp_choices_plain(*[a.cpu() for a in dp_in]))
    results["dp"] = dict(max_abs_err=compare("dp", got, want), plain_ms=plain,
                         ms=cuda_ms(lambda: dp_cuda.dp_choices(*dp_in), 3))
    print(f"dp: equal on {tuple(dp_in[0].shape)} lanes x positions; kernel "
          f"{results['dp']['ms']:.2f} ms, plain {plain:.1f} ms")

    n_pad = split_bucket(HALO + mbs)
    rl = torch.nn.functional.pad(lens[:, :, 0], (0, n_pad - lens.shape[1]))
    step = torch.where(rl >= 3, rl, 1).contiguous()
    start = torch.full((W,), HALO, dtype=torch.int32, device=dev)
    n_real = torch.tensor([HALO + hi - lo for lo, hi in spans], dtype=torch.int32, device=dev)
    got = chain_cuda.chain_marks(step, start, n_real)
    want, plain = host_ms(lambda: chain_cuda.chain_marks_plain(step.cpu(), start.cpu(),
                                                               n_real.cpu()))
    results["chain"] = dict(max_abs_err=compare("chain", got.to(torch.int32),
                                                want.to(torch.int32)),
                            plain_ms=plain, ms=cuda_ms(lambda: chain_cuda.chain_marks(
                                step, start, n_real), 3))
    print(f"chain: equal on {tuple(step.shape)} splitter lanes; kernel "
          f"{results['chain']['ms']:.2f} ms, plain {plain:.1f} ms")

    # -- phase 4: the one-shot path end to end ---------------------------
    engine.set_engine("native")
    compress_device(data, 2, device=dev)  # warm-up: allocator, library, caches
    for mod in (walk_cuda, dp_cuda, chain_cuda):
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = compress_device(data, 2, device=dev)
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    counts = {"walk": walk_cuda.launches, "dp": dp_cuda.launches, "chain": chain_cuda.launches}
    t0 = time.perf_counter()
    ref = zt.compress(data, 2)
    native_s = time.perf_counter() - t0
    if out != ref:
        raise SystemExit(f"gzip: port output ({len(out)} B) differs from native ({len(ref)} B)")
    if zlib.decompress(out, 31) != data:
        raise SystemExit("gzip: zlib does not decode the port's output to the input")
    for name, c in counts.items():
        if c <= 0:
            raise SystemExit(f"{name}: the one-shot run launched no {name} kernel")
    mb = len(data) / 1e6
    print(f"one-shot gzip {len(data)} B -> {len(out)} B, byte-identical to native; "
          f"port {mb / port_s:.3f} MB/s ({port_s:.2f} s), native {mb / native_s:.3f} MB/s "
          f"({native_s:.2f} s) on {smi}; launches {counts}")

    cases = [
        ("deflate", data[: 1 << 20], 0, 0, None),
        ("zlib", data[1 << 20 : 2 << 20], 1, 65536, None),
        ("dictionary", data[2 << 20 : (2 << 20) + 300000], 1, 0, data[:3000]),
        ("stored", np.random.default_rng(args.seed).integers(0, 256, 65536, np.uint8).tobytes(),
         2, 0, None),
    ]
    for name, d, flags, block, dictionary in cases:
        got = compress_device(d, flags, block, dictionary, device=dev)
        if got != zt.compress(d, flags, block, dictionary):
            raise SystemExit(f"{name}: port output differs from native")
        wbits = {0: -15, 1: 15, 2: 31}[flags]
        dec = zlib.decompressobj(wbits, zdict=dictionary) if dictionary else zlib.decompressobj(wbits)
        if dec.decompress(got) + dec.flush() != d:
            raise SystemExit(f"{name}: zlib does not decode the port's output to the input")
        print(f"{name}: {len(d)} B -> {len(got)} B, byte-identical to native, decodes")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        **({"main_path_ms": r["main_path_ms"]} if "main_path_ms" in r else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
