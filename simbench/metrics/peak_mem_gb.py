"""The most device memory allocated during the window (GB, 1e9 bytes):
what caps the cohort a user can simulate on one card."""


def read(ctx):
    return ctx.peak_bytes / 1e9
