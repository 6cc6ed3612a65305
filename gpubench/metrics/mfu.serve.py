"""Model FLOPs of the served requests over the window, as a share of the
card's bf16 peak."""
from gpubench import measure


def read(ctx):
    return measure.mfu(ctx, "serve")
