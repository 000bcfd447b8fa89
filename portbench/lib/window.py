"""The run's clock, kept at round ends.

The program's driver calls ``log`` once a round, after the round's last
step has been enqueued. There ``RoundClock`` waits for the device, stamps
the round's end and hands the driver's frame to the run's hooks (the
captures of ``correct``, the traced stretch). The first round is the
warm-up: set-up runs from process start to its end, and the window from
there to the first round end at or after ``seconds`` of window time; there
``log`` raises ``StopWindow``, which ends the program's call. Time the
hooks spend at a round end is the harness's, not the program's: the
window's clock (``ends``, one entry a round) leaves it out, and so do the
peaks (``setup_peak``, ``window_peak``), read before the hooks, with the
device's peak reset after them.
"""
from __future__ import annotations

import math
import sys
import time

import torch


class StopWindow(Exception):
    """Raised from the program's ``log`` once the window has closed."""


class RoundClock:
    """``device``: the run's ``torch.device``; on the CPU (the harness's
    own tests) there is nothing to wait for and no device memory."""

    def __init__(self, t0: float, seconds: float, on_round, device):
        self.t0, self.seconds, self.on_round = t0, seconds, on_round
        self.cuda = torch.device(device).type == "cuda"
        self.ends = []          # round ends on the clock without the hooks
        self.stamps = []        # round ends on time.perf_counter
        self.paused = 0.0
        self.failed = 0
        self.setup_s = self.w1 = None
        self.setup_peak = self.window_peak = 0

    @property
    def rounds(self) -> int:
        """Whole rounds in the window."""
        return len(self.ends) - 1

    @property
    def window_s(self) -> float:
        return self.ends[-1] - self.ends[0]

    def _peak(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def log(self, line: str) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.stamps.append(t)
        self.ends.append(t - self.paused)
        n = len(self.ends)
        frame = sys._getframe(1)
        if n > 1 and not all(math.isfinite(float(x))
                             for x in frame.f_locals["losses"]):
            self.failed += 1
        # the program's peak since the last hook, read before this one:
        # what the hooks allocate is the harness's
        if n == 1:
            self.setup_s = t - self.t0
            self.setup_peak = self._peak()
        else:
            self.window_peak = max(self.window_peak, self._peak())
        if n > 1 and self.ends[-1] - self.ends[0] >= self.seconds:
            self.w1 = t
            self.on_round(n, frame)
            raise StopWindow
        self.on_round(n, frame)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.paused += time.perf_counter() - t
