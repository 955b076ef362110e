"""Event-driven PS simulator: deterministic asynchrony with an explicit
staleness model (``repro/core/scheduler.py``, on numpy as written there,
so the simulated clock and the completion order equal the reference's).

One synchronous step cannot express cross-job asynchrony, so the
convergence behaviour of the async modes (dist-ASGD, mpi-ASGD, dist-ESGD)
is reproduced here: each *unit* (a worker, or an MPI client acting as one
unit) has its own clock; completions are processed in simulated-time
order; a unit always computes its gradient against the params it pulled
at dispatch time — the staleness the paper's §2.3 discusses falls out of
the event order rather than being injected artificially.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    unit: int = field(compare=False)


@dataclass
class UnitTiming:
    """Per-unit compute-time distribution (lognormal jitter around base)."""

    base: float
    jitter: float
    rng: np.random.Generator

    def sample(self) -> float:
        if self.jitter <= 0:
            return self.base
        return float(self.base * self.rng.lognormal(0.0, self.jitter))


class AsyncEngine:
    """Runs units' (dispatch -> complete -> update) cycles in time order.

    ``on_complete(unit, now) -> float`` performs the unit's server
    interaction and returns the communication time to charge before the
    unit's next dispatch.
    """

    def __init__(self, num_units: int, timing: list[UnitTiming]):
        self.num_units = num_units
        self.timing = timing
        self.now = 0.0
        self._heap: list[_Event] = []
        self._seq = 0
        self.completions = 0
        # membership failures: killed units' in-flight events are
        # discarded and they are never re-dispatched — the survivors
        # keep draining the completion budget (elastic semantics)
        self.dead: set[int] = set()

    def start(self) -> None:
        for u in range(self.num_units):
            self._push(u, self.timing[u].sample())

    def _push(self, unit: int, dt: float) -> None:
        self._seq += 1
        heapq.heappush(self._heap, _Event(self.now + dt, self._seq, unit))

    def kill(self, unit: int) -> None:
        """Mark a unit dead (fault injection / membership failure)."""
        self.dead.add(unit)

    def run(self, until_completions: int,
            on_complete: Callable[[int, float], float]) -> None:
        """``on_complete(unit, now)`` may return None to signal the unit
        died AT this dispatch (core/faults.py kill events): the event
        neither counts as a completion nor re-queues the unit."""
        while self.completions < until_completions and self._heap:
            ev = heapq.heappop(self._heap)
            if ev.unit in self.dead:
                continue
            self.now = ev.time
            comm = on_complete(ev.unit, self.now)
            if comm is None:
                self.dead.add(ev.unit)
                continue
            self.completions += 1
            if ev.unit not in self.dead:
                self._push(ev.unit, comm + self.timing[ev.unit].sample())


@dataclass
class StalenessTracker:
    """Server-version bookkeeping: staleness of a push = server_version at
    apply time − server_version the pusher pulled."""

    server_version: int = 0
    pulled_version: dict[int, int] = field(default_factory=dict)
    history: list[int] = field(default_factory=list)

    def on_pull(self, unit: int) -> None:
        self.pulled_version[unit] = self.server_version

    def on_apply(self, unit: int) -> int:
        stale = self.server_version - self.pulled_version.get(unit, 0)
        self.history.append(stale)
        self.server_version += 1
        return stale

    def mean_staleness(self) -> float:
        return float(np.mean(self.history)) if self.history else 0.0
