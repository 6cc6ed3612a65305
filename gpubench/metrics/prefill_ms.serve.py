"""The engine's prefill of a chunk (the prefill graph's replay and the
first argmax), device milliseconds per chunk over the window's calls."""
from gpubench import phases


def read(ctx):
    return phases.device_ms(ctx, "serve", ["serve.prefill"], "count")
