"""The card's idle share of a traced serving call."""
from gpubench import measure


def read(ctx):
    return measure.idle_share(ctx, "serve")
