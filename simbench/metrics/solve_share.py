"""Share of the window the host spent in the program's ``policy.solve``
span (the HASFL controller's BCD solve: Proposition-1 BS steps and
Dinkelbach MS steps), in percent."""
from simbench.program import span_seconds


def read(ctx):
    seconds = span_seconds("policy.solve")
    if seconds is None:
        return None
    return 100.0 * seconds / ctx.window_s
