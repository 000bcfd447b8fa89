"""A step captured once as a CUDA graph and replayed.

An eager ViT step at batch 256 launches a few thousand small kernels from
Python and leaves the card idle while the host enqueues them; a replay of
the same step captured as a graph is one launch. ``GraphedStep(step,
device)`` captures ``step()``, a function of static tensors that writes
its results back into them (so each replay continues from the one
before). The caller fills the static inputs before each ``replay()``, on
the current stream, which the replay runs on too. A replay reads the
memory of every tensor that the capture read, so each one allocated
outside the capture has to stay referenced until ``close()``.

Captures on a device share one side stream and one memory pool, and one
``GraphedStep`` at a time may be open there. ``close()`` ends the step
but keeps its graph, never to be replayed again, until the next capture
on the device has taken its pool over: that capture reuses the blocks the
last one freed and allocates nothing new. A pool released with its graph
goes back to the device only when the allocator's cache is emptied, so a
pool per capture would add one step's intermediates to the reserved
memory at every capture (3.67 GiB a round for the benchmark's
calibration on an H100), and each capture would allocate them from the
device again. cuBLAS's workspaces (PyTorch keeps one per stream and thread, and
frees them only when told) are dropped around each capture, as PyTorch's
own graph trees do: the capture's own then lies in the pool, which only
the graph uses, and none stays allocated after the capture. The
``torch.cuda.graph`` context manager is not used: it synchronises and
empties the allocator's cache before each capture, which would hand back
the cached blocks of the rest of the program each time.
``kernels.ops.GraphLaunches`` keeps the kernel launch counters true.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from repro_torch.kernels import ops


class GraphedStep:
    # device index -> [side stream, the last closed graph (kept for its
    # memory pool) or None, whether a step is open there]
    _per_device: Dict[int, list] = {}

    @staticmethod
    def available(device) -> bool:
        """Whether a step on ``device`` can be captured: on CUDA."""
        return torch.device(device).type == "cuda"

    def __init__(self, step: Callable[[], None], device):
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        shared = self._per_device.get(index)
        if shared is None:
            with torch.cuda.device(index):
                shared = [torch.cuda.Stream(), None, False]
            self._per_device[index] = shared
        side, last, busy = shared
        if busy:
            raise RuntimeError(f"a captured step is already open on "
                               f"cuda:{index}; close it first")
        self.graph = torch.cuda.CUDAGraph()
        self.launches = ops.GraphLaunches()
        self.replays = 0
        self._shared = shared
        current = torch.cuda.current_stream(index)
        side.wait_stream(current)
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.stream(side), self.launches.capture():
                self.graph.capture_begin(
                    pool=None if last is None else last.pool())
                try:
                    step()
                except BaseException:
                    # end the capture; the step's own error is the one to
                    # see
                    with contextlib.suppress(RuntimeError):
                        self.graph.capture_end()
                    with contextlib.suppress(RuntimeError):
                        self.graph.reset()
                    raise
                self.graph.capture_end()
        finally:
            torch._C._cuda_clearCublasWorkspaces()
        current.wait_stream(side)
        # its pool lives on in this graph; destroyed at close(), while the
        # card runs this graph's last replay
        self._previous = last
        shared[1:] = [None, True]

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replayed()
        self.replays += 1

    def close(self) -> None:
        """End the step; its graph stays with the device, unreplayed, for
        the next capture's pool."""
        if self._previous is not None:
            self._previous.reset()
            self._previous = None
        self._shared[1:] = [self.graph, False]
        self.graph = None
