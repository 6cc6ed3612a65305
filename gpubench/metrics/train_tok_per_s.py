"""Trained tokens a second: the tokens of every step the window completed,
over the window."""
from gpubench import measure


def read(ctx):
    return measure.rate(ctx, "train")
