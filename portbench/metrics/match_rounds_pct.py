"""Share of the match program's doubling rounds that ran, over the traced
window: 100 match.rounds_run / match.rounds, the program's counters (a
batch launches num_levels(n) = 17 rounds for each of its W k segments; a
segment whose ranks are already distinct skips the rest)."""

from portbench.progtrace import program_report


def read(ctx):
    c = (program_report() or {}).get("counters", {})
    rounds = c.get("match.rounds")
    return 100.0 * c.get("match.rounds_run", 0) / rounds if rounds else None
