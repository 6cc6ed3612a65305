"""The card's measured energy over the window (power.draw), per token of
the cell's throughput."""
from gpubench import measure


def read(ctx):
    return measure.joules_per_token(ctx)
