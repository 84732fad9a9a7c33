"""What a driver gets and what it returns."""
from __future__ import annotations

import sys
from dataclasses import dataclass


def log(msg):
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments, the device."""
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    log: object = log


@dataclass
class Outcome:
    """What a driver returns: end-to-end values by metric name, the traced
    readings the per-layer readers take, the checks (name -> (value, limit))."""
    attempted: int
    failed: int
    e2e: dict
    readings: dict
    checks: dict
    memory_peak_bytes: int
    breakdown: dict = None
