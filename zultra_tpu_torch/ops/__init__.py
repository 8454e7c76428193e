"""Device stages of the port: symbol maps, suffix arrays, match tables,
the Huffman bundle, the splitter, the block planner, and the wrappers of
the walk, DP, chain, MK, Kraft, matchlen and byte-histogram kernels. Nothing here imports at
package load; each module is imported where it is used."""

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
