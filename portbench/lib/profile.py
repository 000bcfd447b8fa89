"""The traced run's device trace: ``torch.profiler`` over a stretch of
whole rounds at the start of the window, read in memory.

``Stretch`` starts the profiler at a round's end, after the device has
finished, and stops it at a later round's end, after the device has
finished again; the two host-clock stamps (the profiler's epoch clock)
are the stretch. It records the device's activities (kernels, copies,
sets) and the CUDA runtime calls, and no host operator: recording every
operator slowed a traced ViT round 2.2x and an LM round 1.6x on an H100,
which idled the card for the profiler's sake. It reads the port's
kernel launch counters (``repro_torch.kernels.ops.LAUNCHES``) at both
ends. Nothing is written to disk.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

# the profiler's own host events, which name nothing the program does
PROFILER_OWN = ("Activity Buffer Request",)


class Stretch:
    def __init__(self, launches: Dict[str, int]):
        from torch.profiler import ProfilerActivity, profile
        self._launches = launches
        self._at_start = dict(launches)
        # the CPU (the harness's own tests) has no device track to record
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self._prof.start()
        self.t0 = time.time_ns()
        self.rounds = 0
        self.first = self.last = None     # round ends (1-based) around it

    def stop(self) -> None:
        """At a round's end, after ``torch.cuda.synchronize()``."""
        self.t1 = t1 = time.time_ns()
        t0 = self.t0
        self._prof.stop()
        self.launches = {k: v - self._at_start.get(k, 0)
                         for k, v in self._launches.items()}
        # the profiler's clock is the epoch's, the spans' perf_counter's
        self.clock_offset_ns = time.time_ns() - time.perf_counter_ns()
        device, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((name, e.start_ns(), e.end_ns()))
            elif name not in PROFILER_OWN:
                host.append((name, e.start_ns(), e.end_ns()))
        self._prof = None
        self.device = [d for d in device if d[2] > t0 and d[1] < t1]
        self.host = [h for h in host if h[2] > t0 and h[1] < t1]

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's activity in the stretch, as merged
        (start, end) intervals in ns."""
        out: List[list] = []
        for _, a, b in sorted(self.device, key=lambda d: d[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def kernel_seconds(self, match) -> Tuple[float, int]:
        """(summed seconds, count) of the device activities whose name
        ``match`` accepts."""
        hits = [b - a for n, a, b in self.device if match(n)]
        return sum(hits) / 1e9, len(hits)

    def top_device_ops(self, n: int = 10):
        tot: Dict[str, float] = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e9
        return sorted(([k[:160], v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, spans, n: int = 10):
        """The longest gaps between device activity in the stretch, each
        named by what the host was in at its midpoint: the innermost span
        of the program's tracer and the CUDA runtime call, if any."""
        busy = self.busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                       if b > a), reverse=True)[:n]
        out = []
        for length, a, b in gaps:
            mid = (a + b) // 2
            op = max((h for h in self.host if h[1] <= mid <= h[2]),
                     key=lambda h: h[1], default=("host", 0, 0))[0]
            t = (mid - self.clock_offset_ns) / 1e9
            span = max((s for s in spans if s[1] <= t <= s[2]),
                       key=lambda s: s[1], default=("-", 0, 0))[0]
            out.append([f"{span}/{op}"[:160], length / 1e9])
        return out
