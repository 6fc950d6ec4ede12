"""Useful rows over rows computed in the window's rounds, from the
program's counters: every client's batch is padded to the segment's
power-of-two ``b_pad``; the rows that the row mask and the participation
plan keep are useful.  In percent."""
from simbench.program import profiled


def read(ctx):
    counters = profiled()["counters"]
    if not counters.get("rows_computed"):
        return None
    return 100.0 * counters["rows_useful"] / counters["rows_computed"]
