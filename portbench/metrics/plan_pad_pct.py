"""Share of the planner's lane positions that hold no block, over the
traced window: 100 (1 - plan.input / plan.positions), the program's
counters (a bucket's lanes, padded to a power of two, times its width)."""

from portbench.progtrace import program_report


def read(ctx):
    c = (program_report() or {}).get("counters", {})
    positions = c.get("plan.positions")
    return 100.0 * (1.0 - c.get("plan.input", 0) / positions) if positions else None
