"""The paper's O_kl (the host enqueueing a chunk's work) of the accelerator
group, a share of the serving calls' time."""
from gpubench import measure


def read(ctx):
    return measure.overhead(ctx, "serve", "O_kl")
