"""The arithmetic of the per-layer metrics that read the program's phase
spans. Each call's report carries its phases as the program summed them
where the work ran (``report.phases``: name -> ``device_s``, ``host_s``,
``count``, ``steps``); a metric divides their device seconds by a count
at read time. A program whose reports have no phases gives nothing to
read."""
from __future__ import annotations

from typing import Optional, Sequence


def device_ms(ctx, kind: str, names: Sequence[str], per: str) \
        -> Optional[float]:
    """The device milliseconds of the phases ``names`` over the window's
    calls, divided by ``per``: ``"calls"``, or a tally of the first of
    ``names`` (``"count"``, the times it ran; ``"steps"``, the steps
    counted in it)."""
    if ctx.driver.kind != kind or not ctx.calls:
        return None
    seconds, n = 0.0, 0
    for call in ctx.calls:
        phases = getattr(call.report, "phases", None) or {}
        if any(name not in phases for name in names):
            return None
        seconds += sum(phases[name]["device_s"] for name in names)
        n += 1 if per == "calls" else phases[names[0]][per]
    if n <= 0:
        return None
    return 1e3 * seconds / n
