"""Serving engine of the port: the scheduler applied to batched inference."""
