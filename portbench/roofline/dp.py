"""The DP's work: the optimal-parse cost DP of zultra
(src/blockdeflate.c:95-507), run over every position of a block once a
pass, 3 + 1 passes a dynamic block (src/blockdeflate.c:871-920).

A pass at one position reads the position's match candidates, 8 of
them, each a 2-byte length and a 2-byte offset (zultra's match table),
and the literal byte, and writes the chosen length and offset, 2 + 2
bytes. The costs of later positions that it reads are a sliding set a
kernel can keep on chip, so they are not counted. That is the least
that any implementation moves from and to memory.
"""

PASSES = 4
CANDIDATES = 8
BYTES_PER_POSITION = CANDIDATES * (2 + 2) + 1 + (2 + 2)


def bytes_moved(positions: int) -> int:
    """Least bytes the DP moves over ``positions`` block positions."""
    return positions * PASSES * BYTES_PER_POSITION
