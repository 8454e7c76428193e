"""Command-line tool of the port, mirroring the reference CLI surface
(tool/zultra.c:778-935) as zultra_tpu/cli.py does:

    python -m zultra_tpu_torch.cli [-gzip|-zlib|-deflate] [-v] [-D dict]
                                   [-c|-cbench|-test|-quicktest] <in> [out]

* default     — file compression in one shot on the card (windows batched
                through the device, the same bytes as the reference's
                16 KB chunked stream)
* -c          — verify after compress: re-inflate with stock zlib and
                compare against the original (tool/zultra.c:241-421)
* -cbench     — in-memory benchmark, best of 5 runs, through the port's
                ``Stream`` with guard bytes around its output arena
                (tool/zultra.c:645-774)
* -test/-quicktest — randomized self-test sweep: generated LZ data across
                sizes × alphabet sizes × match probabilities, compressed
                and re-inflated with stock zlib (tool/zultra.c:465-641)

Exit code 100 on any error, as the reference. Copy of zultra_tpu/cli.py
with the one-shot branch of ``do_compress`` only (zultra_tpu takes it for
every engine with ``compress_corpus``, and the port's engine has it) and
a self-test whose tiny-input probes let no error but the empty input's
pass. ``main`` takes ``device`` ("cuda"); the command line has no flag for it.
"""

from __future__ import annotations

import sys
import time
import zlib

import numpy as np

from . import (
    FLAG_DEFLATE_FRAMING,
    FLAG_GZIP_FRAMING,
    FLAG_ZLIB_FRAMING,
    compress,
)
from .constants import HISTORY_SIZE

CHUNK_SIZE = 16384  # the reference CLI's read size (zultra_tpu/cli.py:37)


def _load_dictionary(path: str) -> bytes:
    data = open(path, "rb").read()
    return data[-HISTORY_SIZE:]


def _decompress(blob: bytes, flags: int, dictionary: bytes | None = None) -> bytes:
    if flags & FLAG_GZIP_FRAMING:
        return zlib.decompress(blob, 15 + 16)
    if flags & FLAG_ZLIB_FRAMING:
        if dictionary:
            d = zlib.decompressobj(15, zdict=dictionary)
            return d.decompress(blob) + d.flush()
        return zlib.decompress(blob, 15)
    return zlib.decompress(blob, -15)


def do_compress(in_path: str, out_path: str, flags: int, dictionary: bytes | None,
                verbose: bool, verify: bool, device="cuda") -> int:
    from .stream import StreamError

    start = time.perf_counter()

    data = open(in_path, "rb").read()
    try:
        blob = compress(data, flags, dictionary=dictionary, device=device)
    except StreamError as exc:
        print(f"error compressing '{in_path}': {exc}", file=sys.stderr)
        return 100
    open(out_path, "wb").write(blob)
    elapsed = time.perf_counter() - start
    if verbose:
        speed = (len(data) / 1048576.0) / max(elapsed, 1e-9)
        ratio = len(blob) * 100.0 / max(len(data), 1)
        print(
            f"Compressed '{in_path}' in {elapsed:.3f} seconds, "
            f"{speed:.2f} MB/s, {len(data)} into {len(blob)} bytes "
            f"==> {ratio:.2f} %"
        )
    if verify:
        if _decompress(blob, flags, dictionary) != data:
            print("verify FAILED: decompressed data differs", file=sys.stderr)
            return 100
        if verbose:
            print("Compressed data verified OK")
    return 0


GUARD = 1024
GUARD_BYTE = 0xAA


def compress_guarded(data: bytes, flags: int, max_block_size: int = 0,
                     device="cuda") -> bytes:
    """One in-memory compression run through a guarded output arena: the
    stream's per-window output buffer — the memory the emitter actually
    writes into — is a view between two guard regions, so a real buffer
    overrun corrupts the guards (reference tool/zultra.c:710-753
    semantics, adapted to the per-window buffer model). Raises
    RuntimeError when a guard trips."""
    from .stream import Stream, clamp_block_size

    mbs = clamp_block_size(max_block_size)
    out_cap = 1 + mbs + (1 + 4) * ((mbs // 65535) + 1)
    arena = bytearray(bytes([GUARD_BYTE]) * (GUARD + out_cap + GUARD))
    region = memoryview(arena)[GUARD : GUARD + out_cap]
    stream = Stream(flags, mbs, out_buffer=region, device=device)
    out = stream.compress(data, 1)
    del region
    if (arena[:GUARD] != bytes([GUARD_BYTE]) * GUARD
            or arena[GUARD + out_cap:] != bytes([GUARD_BYTE]) * GUARD):
        raise RuntimeError("guard bytes corrupted")
    return out


def do_benchmark(in_path: str, flags: int, verbose: bool, device="cuda") -> int:
    data = open(in_path, "rb").read()

    best = None
    comp = b""
    for run in range(5):
        t0 = time.perf_counter()
        try:
            comp = compress_guarded(data, flags, device=device)
        except RuntimeError as exc:
            print(str(exc), file=sys.stderr)
            return 100
        elapsed = time.perf_counter() - t0
        best = elapsed if best is None else min(best, elapsed)
        if verbose:
            print(f"run {run}: {len(data)/1048576.0/elapsed:.2f} MB/s")

    if _decompress(comp, flags) != data:
        print("roundtrip FAILED", file=sys.stderr)
        return 100
    print(
        f"compressed size: {len(comp)} bytes ({len(comp)*100.0/max(len(data),1):.2f} %), "
        f"best {len(data)/1048576.0/best:.2f} MB/s"
    )
    return 0


def generate_compressible_data(rng: np.random.RandomState, size: int,
                               n_literals: int, match_probability: float) -> bytes:
    buf = bytearray()
    if size == 0:
        return b""
    buf.append(int(rng.randint(n_literals)))
    while len(buf) < size:
        if rng.random_sample() >= match_probability:
            count = min(int(rng.randint(128)), size - len(buf))
            buf.extend(int(x) for x in rng.randint(0, n_literals, max(count, 0)))
        else:
            length = min(3 + int(rng.randint(1024)), size - len(buf), len(buf))
            offset = 1 + int(rng.randint(len(buf)))
            for _ in range(length):
                buf.append(buf[-offset])
    return bytes(buf)


def do_self_test(quick: bool, verbose: bool, device="cuda") -> int:
    """zultra_tpu/cli.py's self-test, except that the tiny-input probes
    catch only the ``StreamError`` of an empty input, and a probe that
    compresses must inflate back to its input."""
    from .stream import StreamError

    rng = np.random.RandomState(123)
    flags = FLAG_ZLIB_FRAMING

    # Tiny-input probes: empty input is refused, every other one round-trips.
    for i in range(12):
        data = generate_compressible_data(rng, i, 256, 0.5)
        try:
            blob = compress(data, flags, device=device)
        except StreamError:
            if data:
                raise
            continue
        if zlib.decompress(blob) != data:
            print(f"FAILED: tiny input of {i} bytes", file=sys.stderr)
            return 100

    sizes = [4096] if quick else [4096, 16384, 65536, 4 * HISTORY_SIZE]
    alphabets = [1, 2, 3, 15, 30, 56, 96, 137, 178, 191, 255, 256]
    probs = [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 0.995]
    n_tests = 0
    for size in sizes:
        for n_lit in alphabets:
            for prob in probs if not quick else probs[::2]:
                data = generate_compressible_data(rng, size, n_lit, prob)
                blob = compress(data, flags, device=device)
                if zlib.decompress(blob) != data:
                    print(
                        f"FAILED: size={size} alphabet={n_lit} p={prob}",
                        file=sys.stderr,
                    )
                    return 100
                n_tests += 1
                if verbose and n_tests % 20 == 0:
                    print(f"{n_tests} tests passed...")
    print(f"All {n_tests} self-tests passed")
    return 0


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = FLAG_GZIP_FRAMING
    verbose = False
    verify = False
    bench = False
    self_test = quick_test = False
    dict_path = None
    positional = []

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "-gzip":
            flags = FLAG_GZIP_FRAMING
        elif arg == "-zlib":
            flags = FLAG_ZLIB_FRAMING
        elif arg == "-deflate":
            flags = FLAG_DEFLATE_FRAMING
        elif arg == "-v":
            verbose = True
        elif arg == "-c":
            verify = True
        elif arg == "-cbench":
            bench = True
        elif arg == "-test":
            self_test = True
        elif arg == "-quicktest":
            quick_test = True
        elif arg == "-D":
            i += 1
            dict_path = argv[i]
        elif arg.startswith("-"):
            print(f"unknown option {arg}", file=sys.stderr)
            return 100
        else:
            positional.append(arg)
        i += 1

    if self_test or quick_test:
        return do_self_test(quick_test, verbose, device=device)

    if dict_path is not None and not (flags & FLAG_ZLIB_FRAMING):
        print("dictionaries are only supported with zlib framing", file=sys.stderr)
        return 100

    if bench:
        if len(positional) < 1:
            print("usage: zultra_tpu_torch -cbench <infile>", file=sys.stderr)
            return 100
        return do_benchmark(positional[0], flags, verbose, device=device)

    if len(positional) != 2:
        print(
            "usage: python -m zultra_tpu_torch.cli [-gzip|-zlib|-deflate] [-v] "
            "[-D dict] [-c|-cbench|-test|-quicktest] <infile> <outfile>",
            file=sys.stderr,
        )
        return 100

    dictionary = _load_dictionary(dict_path) if dict_path else None
    return do_compress(positional[0], positional[1], flags, dictionary, verbose, verify,
                       device=device)


if __name__ == "__main__":
    raise SystemExit(main())
