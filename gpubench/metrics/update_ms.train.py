"""The trainer's update (the global norm, the clip and AdamW) and the
refresh of the weights' copies after it, device milliseconds per step
over the window's steps."""
from gpubench import phases


def read(ctx):
    return phases.device_ms(ctx, "train", ["train.update", "train.refresh"],
                            "calls")
