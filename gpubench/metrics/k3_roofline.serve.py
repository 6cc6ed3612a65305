"""K3 (the Mamba-2 SSD scan) in the serving prefill: its share of its
roofline."""
from gpubench import measure


def read(ctx):
    return measure.roofline(ctx, "serve", "k3")
