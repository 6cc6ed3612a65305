"""K2 (flash decode) in the serving decode steps: its share of its roofline."""
from gpubench import measure


def read(ctx):
    return measure.roofline(ctx, "serve", "k2")
