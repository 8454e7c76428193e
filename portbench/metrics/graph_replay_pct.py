"""Share of the program calls in the traced window that replayed a
captured graph: 100 replay / (replay + capture + eager), the counters of
ops/programs.py. Nothing on the CPU, where no call goes through a graph."""

from portbench.progtrace import program_report


def read(ctx):
    c = (program_report() or {}).get("counters", {})
    calls = sum(c.get(f"program.{k}", 0) for k in ("replay", "capture", "eager"))
    return 100.0 * c.get("program.replay", 0) / calls if calls else None
