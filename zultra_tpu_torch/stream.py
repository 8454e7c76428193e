"""The three pieces of zultra_tpu/stream.py that the one-shot path needs:
``StreamError``, ``clamp_block_size`` and ``memory_bound``, copied so
that the port imports nothing of zultra_tpu. The streaming core itself
(``Stream``) stays in zultra_tpu; the port's ``DeviceWindowEngine``
plugs into it through the engine contract.
"""

from __future__ import annotations

from . import frame
from .constants import (
    DEFAULT_MAX_BLOCK_SIZE,
    MAX_BLOCK_SIZE_LIMIT,
    MAX_SPLITS,
    MIN_BLOCK_SIZE_LIMIT,
)


class StreamError(Exception):
    pass


def clamp_block_size(max_block_size: int) -> int:
    if not max_block_size:
        max_block_size = DEFAULT_MAX_BLOCK_SIZE
    return max(MIN_BLOCK_SIZE_LIMIT, min(MAX_BLOCK_SIZE_LIMIT, max_block_size))


def memory_bound(input_size: int, flags: int = 0, max_block_size: int = 0) -> int:
    """(reference src/libzultra.c:576-587)"""
    max_block_size = clamp_block_size(max_block_size)
    return (
        frame.get_header_size(flags, None)
        + ((input_size + max_block_size - 1) // max_block_size) * (1 + 4 + 1) * MAX_SPLITS
        + input_size
        + 1
        + frame.get_footer_size(flags)
    )
