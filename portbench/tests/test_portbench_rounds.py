"""The reader of match_rounds_pct on a planted report of the program's
counters, and on a report without them (a program that counts no
doubling rounds reads as nothing)."""

import pytest

from portbench import progtrace, spec


def read(ctx):
    """The reader, loaded anew: it binds the report function it finds."""
    return spec.reader("match_rounds_pct")(ctx)


def test_match_rounds_pct_on_a_planted_report(monkeypatch):
    ctx = {"calls": [(0.0, 1.0, 1 << 20, True)]}
    # Two batches of 32 segments, 17 rounds launched for each; 5 rounds
    # run on 60 segments, 1 on the 4 padded ones.
    program = {"spans": {}, "counters": {"match.rounds": 2 * 32 * 17,
                                         "match.rounds_run": 60 * 5 + 4}}
    monkeypatch.setattr(progtrace, "program_report", lambda: program)
    assert read(ctx) == pytest.approx(100 * 304 / 1088)
    program["counters"]["match.rounds_run"] = 2 * 32 * 17  # no segment skipped a round
    assert read(ctx) == pytest.approx(100.0)
    for report in (None, {"spans": {}, "counters": {}},
                   {"spans": {}, "counters": {"match.positions": 1 << 20}}):
        monkeypatch.setattr(progtrace, "program_report", lambda: report)
        assert read(ctx) is None
