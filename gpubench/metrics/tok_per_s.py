"""Served tokens a second: prompt and generated tokens of every request the
window's calls completed, over the window."""
from gpubench import measure


def read(ctx):
    return measure.rate(ctx, "serve")
