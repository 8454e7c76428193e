"""Device stages of the port: symbol maps, suffix arrays, match tables,
the Huffman bundle, the splitter, the block planner, token emission,
checksums, and the wrappers of the walk, DP, chain, MK, Kraft, matchlen
and byte-histogram kernels. No kernel is built at package load (the
first CUDA launch builds them all).

The exports are the counterparts of zultra_tpu/ops/__init__.py:17-30
(``optimize_matches_jax``, the JAX scan DP kept for cross-checks, has
none: ROADMAP A8)."""

from .checksum import adler32, adler32_combine, crc32_combine
from .histogram_cuda import byte_histogram, token_histogram
from .suffix_torch import plcp, suffix_array

__all__ = [
    "suffix_array",
    "plcp",
    "byte_histogram",
    "token_histogram",
    "adler32",
    "adler32_combine",
    "crc32_combine",
    "launch_counts",
    "reset_launch_counts",
]

# kernel name -> (wrapper module, its launch counter)
_COUNTERS = {
    "walk": ("walk_cuda", "launches"),
    "dp": ("dp_cuda", "launches"),
    "chain": ("chain_cuda", "launches"),
    "mk12": ("mk_cuda", "mk12_launches"),
    "kraft": ("mk_cuda", "kraft_launches"),
    "matchlen": ("matchlen_cuda", "launches"),
    "hist": ("histogram_cuda", "launches"),
}


def _counter(name: str):
    import importlib

    module, attr = _COUNTERS[name]
    return importlib.import_module(f"{__name__}.{module}"), attr


def launch_counts() -> dict:
    """{kernel name: launches since the last reset} for every kernel."""
    return {name: getattr(*_counter(name)) for name in _COUNTERS}


def reset_launch_counts() -> None:
    for name in _COUNTERS:
        setattr(*_counter(name), 0)
