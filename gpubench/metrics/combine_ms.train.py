"""The trainer's fp32 combine of the chunks' gradients, device
milliseconds per step over the window's steps."""
from gpubench import phases


def read(ctx):
    return phases.device_ms(ctx, "train", ["train.combine"], "calls")
