"""Device stages of the port: symbol maps, suffix arrays, match tables
(the walk's, and the staircase match finder's), the NSV queries, the
Huffman bundle, the splitter, the block planner, the DP's entry points,
token emission, checksums, and the wrappers of the walk, DP, chain, MK,
Kraft, matchlen, byte-histogram, RLE-sweep, RLE-statistics,
prefix-table, DP lane preparation, token-histogram, token-emission,
short-row order and suffix-doubling kernels. No kernel is built at package load (the first
CUDA launch builds them all).

The exports are the counterparts of zultra_tpu/ops/__init__.py:17-30;
``optimize_matches`` is that of ``optimize_matches_jax``, the JAX
package's scan DP kept for cross-checks."""

import contextlib
import threading

# Kernel launches since the last reset, one count a kernel. Every wrapper
# adds one through count_launch where it launches its kernel, and nowhere
# else; the lock keeps the counts whole when several host threads launch
# (``compress_device(devices=...)``). A launch made while a CUDA graph is
# captured does not run then: it goes to the capture's own counts, which
# ``programs`` adds back (``add_launches``) on every replay, so a count is
# always of launches the device executed.
KERNEL_NAMES = ("walk", "dp", "chain", "mk12", "kraft", "matchlen", "hist",
                "rle_sweep", "rle_stats", "prefix_tables", "prep_lanes", "token_hist",
                "emit_tokens", "lex_order", "suffix_round")
_counts = dict.fromkeys(KERNEL_NAMES, 0)
_counts_lock = threading.Lock()
_capturing = threading.local()  # .counts: the counts of this thread's capture, or None


def count_launch(name: str) -> None:
    captured = getattr(_capturing, "counts", None)
    if captured is not None:
        captured[name] += 1
        return
    with _counts_lock:
        _counts[name] += 1


def add_launches(counts: dict) -> None:
    """Add the launches of a replayed graph, {kernel name: launches}."""
    with _counts_lock:
        for name, n in counts.items():
            _counts[name] += n


@contextlib.contextmanager
def capturing_launches():
    """Within the block, this thread's launches go to the yielded counts
    (a capture's), not to the totals."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    _capturing.counts = counts
    try:
        yield counts
    finally:
        _capturing.counts = None


def launch_counts() -> dict:
    """{kernel name: launches since the last reset} for every kernel."""
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _counts:
            _counts[name] = 0


from .checksum import adler32, adler32_combine, crc32_combine  # noqa: E402
from .histogram_cuda import byte_histogram, token_histogram  # noqa: E402
from .parse_torch import optimize_matches, optimize_matches_batch  # noqa: E402
from .suffix_torch import plcp, suffix_array  # noqa: E402

__all__ = [
    "suffix_array",
    "plcp",
    "byte_histogram",
    "token_histogram",
    "adler32",
    "adler32_combine",
    "crc32_combine",
    "optimize_matches",
    "optimize_matches_batch",
    "launch_counts",
    "reset_launch_counts",
]
