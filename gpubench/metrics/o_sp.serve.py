"""The paper's O_sp (scheduling and partitioning) of the accelerator group,
a share of the serving calls' time."""
from gpubench import measure


def read(ctx):
    return measure.overhead(ctx, "serve", "O_sp")
