"""Share of the match program's segment-core positions that hold no
input, over the traced window: 100 (1 - match.input / match.positions),
the program's counters (W k 32768 positions a batch)."""

from portbench.progtrace import program_report


def read(ctx):
    c = (program_report() or {}).get("counters", {})
    positions = c.get("match.positions")
    return 100.0 * (1.0 - c.get("match.input", 0) / positions) if positions else None
