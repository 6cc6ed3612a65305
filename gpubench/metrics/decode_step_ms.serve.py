"""The engine's decode loop (each step a decode graph's replay and an
argmax), device milliseconds per decode step over the window's calls."""
from gpubench import phases


def read(ctx):
    return phases.device_ms(ctx, "serve", ["serve.decode"], "steps")
