"""Seconds from the process's start to the window's: imports, the kernel
library load or build, data, the session, the first decision, the checked
rounds and the warm-up period."""


def read(ctx):
    return ctx.setup_s
