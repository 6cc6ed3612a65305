"""The trainer's gradient step of a chunk (the graphed forward and
backward and the gradients' clone), device milliseconds per chunk over
the window's steps."""
from gpubench import phases


def read(ctx):
    return phases.device_ms(ctx, "train", ["train.grad"], "count")
