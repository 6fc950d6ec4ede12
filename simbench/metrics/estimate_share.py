"""Share of the window the host spent in the program's
``policy.estimate`` span (the online G²/σ² estimate of the HASFL
controller: its gradient batches, their copies to fp64 numpy and the
statistics), in percent."""
from simbench.program import span_seconds


def read(ctx):
    seconds = span_seconds("policy.estimate")
    if seconds is None:
        return None
    return 100.0 * seconds / ctx.window_s
