"""The card's idle share of traced training steps."""
from gpubench import measure


def read(ctx):
    return measure.idle_share(ctx, "train")
