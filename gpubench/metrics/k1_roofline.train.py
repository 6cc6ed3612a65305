"""K1 (flash attention with its row log-sum-exp) in the training forward
and its recompute: its share of its roofline."""
from gpubench import measure


def read(ctx):
    return measure.roofline(ctx, "train", "k1")
