"""Model FLOPs of the trained steps (three forwards, no recompute) over the
window, as a share of the card's bf16 peak."""
from gpubench import measure


def read(ctx):
    return measure.mfu(ctx, "train")
