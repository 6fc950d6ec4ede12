"""Simulated rounds completed in the window over its wall seconds, policy
calls and evals included."""


def read(ctx):
    return ctx.rounds / ctx.window_s
