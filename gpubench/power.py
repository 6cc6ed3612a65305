"""The card's measured power over a window, from ``nvidia-smi``.

A child ``nvidia-smi --query-gpu=timestamp,power.draw,clocks.sm -lms
100`` samples the card's power draw (and its SM clock, which the run
reports beside it) every 100 ms from before the warm-up to the window's
end; each line carries
the driver's own timestamp. The energy of the window is the
trapezoid integral of the samples over it. A window whose samples cannot
be read raises (a line cut short by the sampler's stop is not counted):
the energy is never modelled instead.
"""
from __future__ import annotations

import datetime
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

PERIOD_MS = 100


def _stamp(text: str) -> float:
    return datetime.datetime.strptime(
        text.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()


def query(field: str, gpu: str) -> str:
    """One value of ``nvidia-smi --query-gpu`` for card ``gpu``."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={gpu}", f"--query-gpu={field}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0].strip()


class PowerSampler:
    """Samples ``power.draw`` of card ``gpu`` (an index or PCI bus id)
    from ``start()`` to ``stop()``."""

    def __init__(self, gpu: str):
        self.gpu = gpu
        self.samples: List[Tuple[float, float]] = []
        self.clocks: List[Tuple[float, float]] = []
        self.bad: List[str] = []
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None

    def limit_w(self) -> float:
        """The card's power limit, in watts."""
        return float(query("power.limit", self.gpu))

    def start(self) -> None:
        # line-buffered where ``stdbuf`` is there: a sample must not wait
        # in a pipe's buffer when the sampler is stopped
        pre = ["stdbuf", "-oL"] if shutil.which("stdbuf") else []
        self._proc = subprocess.Popen(
            pre + ["nvidia-smi", f"--id={self.gpu}",
             "--query-gpu=timestamp,power.draw,clocks.sm",
             "--format=csv,noheader,nounits", "-lms", str(PERIOD_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        # wait for a first sample, so that the window is covered from its
        # start
        deadline = time.monotonic() + 10.0
        while not self.samples and time.monotonic() < deadline:
            if self._proc.poll() is not None or self.bad:
                break
            time.sleep(0.01)

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                ts, watts, sm = line.split(",")
                t = _stamp(ts)
                self.samples.append((t, float(watts)))
                self.clocks.append((t, float(sm)))
            except ValueError:
                self.bad.append(line.strip())

    def sm_mhz(self, t0: float, t1: float) -> Tuple[float, float]:
        """The lowest and the mean SM clock sampled in [t0, t1]."""
        got = [c for t, c in self.clocks if t0 <= t <= t1] or [0.0]
        return min(got), sum(got) / len(got)

    def stop(self) -> None:
        # one more period, so that the window's end is covered
        time.sleep(2 * PERIOD_MS / 1000)
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)

    def energy_j(self, t0: float, t1: float) -> float:
        """Joules from ``t0`` to ``t1`` (``time.time()`` seconds): the
        trapezoid integral of the samples, clipped to the window."""
        pts = sorted(self.samples)
        if any(b for b in self.bad[:-1]) or len(pts) < 2 or pts[0][0] > t0 + 1.0 \
                or pts[-1][0] < t1 - 1.0:
            raise RuntimeError(
                f"power.draw not read over the window: {len(pts)} samples"
                f" from {pts[0][0] - t0 if pts else None} s to "
                f"{pts[-1][0] - t1 if pts else None} s of its ends, "
                f"unreadable lines {self.bad[:3]}")
        total = 0.0
        for (ta, pa), (tb, pb) in zip(pts, pts[1:]):
            a, b = max(ta, t0), min(tb, t1)
            if b <= a:
                continue
            # the line between the two samples, at a and at b
            pa_ = pa + (pb - pa) * (a - ta) / (tb - ta)
            pb_ = pa + (pb - pa) * (b - ta) / (tb - ta)
            total += 0.5 * (pa_ + pb_) * (b - a)
        # before the first sample and after the last, hold them
        if pts[0][0] > t0:
            total += pts[0][1] * (pts[0][0] - t0)
        if pts[-1][0] < t1:
            total += pts[-1][1] * (t1 - pts[-1][0])
        return total
