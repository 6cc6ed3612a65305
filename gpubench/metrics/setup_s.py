"""Set-up: from the process's start to the window's start (weights, the
program's objects, kernel builds, the warm-up and its graph captures)."""


def read(ctx):
    return ctx.setup_s
