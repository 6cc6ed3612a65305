"""The arithmetic the metric readers share. Each function takes the run's
``bench.Context`` and returns a number, or None where the run has nothing
for it to read."""
from __future__ import annotations

from typing import Optional

from gpubench import cost

#: the share of a kernel's launches the profiler may lose (its activity
#: buffers drop a few records of a window of millions) before the run
#: reads nothing for the kernel's roofline
LOST = 1e-3


def rate(ctx, kind: str) -> Optional[float]:
    """Tokens of every call completed in the window, over the window."""
    if ctx.driver.kind != kind or not ctx.calls:
        return None
    return ctx.tokens / ctx.window_s


def joules_per_token(ctx) -> Optional[float]:
    if ctx.energy_j is None or not ctx.tokens:
        return None
    return ctx.energy_j / ctx.tokens


def mfu(ctx, kind: str) -> Optional[float]:
    """Model FLOPs of the window's completed work over the window and the
    card's bf16 peak, in %."""
    if ctx.driver.kind != kind or ctx.driver.device.type != "cuda":
        return None
    flops = ctx.driver.model_flops(ctx.calls)
    return 100.0 * flops / ctx.window_s / cost.PEAK_BF16_FLOPS


def overhead(ctx, kind: str, key: str) -> Optional[float]:
    """The accelerator group's offload overhead ``key`` (``O_sp``,
    ``O_kl``) of each call, weighted by the call's time, in %."""
    if ctx.driver.kind != kind or not ctx.calls:
        return None
    rep = [c.report for c in ctx.calls]
    total = sum(r.time_s for r in rep)
    return 100.0 * sum(r.overheads["accel"][key] * r.time_s
                       for r in rep) / total


def idle_share(ctx, kind: str) -> Optional[float]:
    """The share of the traced window in which no kernel or copy ran on
    the card, in %."""
    if ctx.driver.kind != kind or ctx.trace is None \
            or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_share


def roofline(ctx, kind: str, kernel: str) -> Optional[float]:
    """The sum of the bound times of ``kernel``'s launches in the traced
    window over the sum of their device times, in %. The launches are
    those the benchmark counts for the chunks the traced calls completed;
    where the profiler saw more of them, or fewer by more than ``LOST``,
    the run reads nothing and says so."""
    if ctx.driver.kind != kind or ctx.trace is None:
        return None
    want = ctx.driver.kernel_work(ctx.traced_calls)[kernel]
    seen = ctx.trace.kernels.get(kernel, [])
    if not want:
        return None
    if len(seen) != len(want):
        ctx.log(f"{kernel}: {len(want)} launches counted, the profiler saw "
                f"{len(seen)}")
        if not 0 < len(want) - len(seen) <= LOST * len(want):
            return None
    # where the profiler lost a few records of a traced window's millions,
    # the lost launches are taken at the mean device time of the others
    device = sum(seen) * len(want) / len(seen)
    bound = sum(cost.bound_s(f, b) for f, b in want)
    return 100.0 * bound / device
