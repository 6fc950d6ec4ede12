"""What the program tallied while the window's profile recorded: its
spans' calls and host seconds and its counters
(`repro_torch.trace.profiled`; the profile records from the window's
first boundary to its last, so the tally is the window's).  Empty where
the program keeps no such tally, so a metric that reads it is left out
there."""
import importlib

EMPTY = {"spans": {}, "counters": {}}


def profiled() -> dict:
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return EMPTY
    tally = getattr(trace, "profiled", None)
    return tally() if tally is not None else EMPTY


def span_seconds(name: str):
    """Host seconds of the program's span ``name`` in the window, or None
    where it never ran."""
    span = profiled()["spans"].get(name)
    return None if span is None else span["host_s"]
