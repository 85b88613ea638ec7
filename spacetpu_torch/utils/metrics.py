"""Observability: elapsed-time formatting, tick-rate tracking, throughput.

The counterpart of `spacetpu/utils/metrics.py`. Ports the reference's
`ElapsedTime` + `compute_elapsed_time` (`sim/mod.rs:129-173`) and the egui info panel's
30-sample rolling tick-rate average (`ui/info.rs:43-53`), and adds the
pair-interactions/sec counter (the reference has no throughput metric at
all). Tree telemetry (`tree_health`) waits for the port of the tree.
"""

from __future__ import annotations

import dataclasses
import time

from spacetpu_torch.constants import SEC_PER_DAY, SEC_PER_HOUR, SEC_PER_YEAR


@dataclasses.dataclass
class ElapsedTime:
    """Y/D/H:M:S decomposition of simulated time (sim/mod.rs:135-147)."""

    years: int = 0
    days: int = 0
    hours: int = 0
    minutes: int = 0
    seconds: float = 0.0
    ticks: float = 0.0

    def __str__(self) -> str:
        # Format mirrors sim/mod.rs:149-157.
        return (
            f"{self.years}Y {self.days}D "
            f"{self.hours:0>2}:{self.minutes:0>2}:{self.seconds:0>2.0f} "
            f"({self.ticks} ticks)"
        )


def compute_elapsed_time(ticks: float, delta: float) -> ElapsedTime:
    """Decompose ticks*delta seconds into Y/D/H:M:S (sim/mod.rs:159-173)."""
    time_s = ticks * delta
    years = time_s // SEC_PER_YEAR
    time_s -= years * SEC_PER_YEAR
    days = time_s // SEC_PER_DAY
    time_s -= days * SEC_PER_DAY
    hours = time_s // SEC_PER_HOUR
    time_s -= hours * SEC_PER_HOUR
    minutes = time_s // 60.0
    seconds = time_s - minutes * 60.0
    return ElapsedTime(
        years=int(years),
        days=int(days),
        hours=int(hours),
        minutes=int(minutes),
        seconds=seconds,
        ticks=ticks,
    )


class TickRateTracker:
    """Rolling average of simulation ticks per wall second over a fixed
    window (ui/info.rs:11-53 uses a 30-sample window)."""

    def __init__(self, window: int = 30):
        self.window = window
        self.rates = [0.0] * window
        self.index = 0
        self.last_tick = 0
        self.last_time = time.monotonic()

    def update(self, tick: int) -> float:
        now = time.monotonic()
        elapsed = max(now - self.last_time, 1e-9)
        self.rates[self.index] = (tick - self.last_tick) / elapsed
        self.index = (self.index + 1) % self.window
        self.last_tick = tick
        self.last_time = now
        return self.average

    @property
    def average(self) -> float:
        return sum(self.rates) / len(self.rates)


class ThroughputTracker:
    """Pair-interactions/sec and steps/sec for a fixed N (new; north-star
    metric — the reference computes nothing like this)."""

    def __init__(self, n: int):
        self.n = n
        self.pairs_per_step = float(n) * float(n)

    def rate(self, steps: int, wall_seconds: float) -> dict:
        wall_seconds = max(wall_seconds, 1e-12)
        return {
            "steps_per_sec": steps / wall_seconds,
            "pairs_per_sec": steps * self.pairs_per_step / wall_seconds,
        }
