"""K1 (flash attention) in the serving prefill: its share of its roofline."""
from gpubench import measure


def read(ctx):
    return measure.roofline(ctx, "serve", "k1")
