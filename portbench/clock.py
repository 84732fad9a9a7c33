"""The measured window: units of work back to back until ``seconds`` have
passed on the host's clock, closed by a device synchronise, so that the
window's time covers all the work it issued."""
from __future__ import annotations

import time

import torch


class Window:
    def __init__(self, seconds, sync=torch.cuda.synchronize):
        self.seconds, self.sync = seconds, sync
        self.units, self.elapsed_s = 0, None

    def run(self, unit):
        """Call ``unit(i)`` for i = 0, 1, ... until the window's time is up;
        returns the seconds from the first call to the synchronise after the
        last."""
        self.sync()
        t0 = time.perf_counter()
        while True:
            unit(self.units)
            self.units += 1
            if time.perf_counter() - t0 >= self.seconds:
                break
        self.sync()
        self.elapsed_s = time.perf_counter() - t0
        return self.elapsed_s
