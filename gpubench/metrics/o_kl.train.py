"""The paper's O_kl (the host enqueueing a chunk's work) of the accelerator
group, a share of the training steps' time."""
from gpubench import measure


def read(ctx):
    return measure.overhead(ctx, "train", "O_kl")
