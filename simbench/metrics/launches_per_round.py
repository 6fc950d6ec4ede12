"""Device operations (kernels, copies, sets) launched inside the harness's
``segment`` range, over the program's ``round`` spans in the window.  The
range holds the segment's rounds and the upload of its plan (a few
copies a segment, against thousands of launches a round); the program's
spans say how many rounds it held."""
from simbench.program import profiled


def read(ctx):
    rounds = profiled()["spans"].get("round", {}).get("calls")
    if ctx.trace is None or not ctx.trace.ops or not rounds:
        return None
    return sum(1 for op in ctx.trace.ops if op[3] == "segment") / rounds
