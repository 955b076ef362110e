"""Deterministic fault injection for the PS/MPI stack (paper §2, §3;
``repro/core/faults.py``, the same schedules and lookups).

The paper's case for embedding MPI groups in a PS task model is that the
loosely-coupled PS tier survives what kills an MPI job wholesale: clients
may fail, straggle, or drop a push between sync barriers. This module is
the harness that *produces* those failures on demand — in the six-mode
simulation (core/algorithms.py), the shard driver
(launch/shard_driver.py), and tests — with one hard rule:

    every lookup is a pure function of (schedule, unit, step).

No wall clock, no shared RNG stream: the same ``FaultSchedule`` replayed
against the same run is bit-identical, and corruption noise is seeded per (seed, unit, step) so it
cannot shift when unrelated events reorder.

Fault kinds (``FaultEvent.kind``):

  drop      the unit's push at ``step`` is lost; ``duration`` counts how
            many consecutive delivery *attempts* fail (retry/backoff in
            the KVStore path can still get it through when
            duration <= retries)
  delay     the unit's push/collective leg at ``step`` arrives ``factor``
            seconds late
  straggle  the unit's compute+comm at steps [step, step+duration) is
            stretched ``factor``×
  corrupt   gaussian noise (scale ``sigma``) is added to the unit's
            pushed value at ``step``
  kill      the unit is dead from ``step`` on (membership failure — see
            core/membership.py for the re-split/re-shard that follows)
  restart   the unit is *authorized to come back*: the shard driver
            (launch/shard_driver.py) re-joins the unit at ``step``
            (growing the layout if it was never live); the socket tier's
            supervisor (not ported yet) respawns a dead process after
            ``delay`` seconds. ``delay`` rides the ``factor`` field
            (default 0.0).

Kills are **generation-indexed**: a respawned or rejoined unit is spawn
generation a, and ``is_killed(unit, step, attempt=a)`` consults the
(a+1)-th scheduled kill for that unit — so generation 0 dies at the
first kill event, its successor survives it (and dies at the second, if
scheduled). ``attempt=0`` is the default: a unit dies at its first kill.

The in-process six-mode simulation (core/algorithms.py) cannot respawn
a unit — it ignores ``restart`` events (the unit stays dead); the shard
driver honors them.

Schedules parse from a compact string form so they thread through CLI
flags and job specs unchanged:

    "kill@12:unit=1;straggle@0:unit=3:factor=4:duration=20"
    "kill@2:unit=1;restart@2:unit=1:delay=0.1"
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map

KINDS = ("drop", "delay", "corrupt", "straggle", "kill", "restart")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``factor`` is the straggle multiplier (×),
    the delay (seconds), or the restart delay (seconds — spelled
    ``delay=`` in the string form, default 0.0); ``duration`` is in
    steps (straggle/kill-free kinds ignore it) or delivery attempts
    (drop); ``sigma`` is the corrupt noise scale."""

    kind: str
    unit: int
    step: int
    factor: float = 2.0
    duration: int = 1
    sigma: float = 0.01

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"fault kind must be one of {KINDS}, got {self.kind!r}")
        if self.step < 0 or self.unit < 0:
            raise ValueError(
                f"fault step/unit must be >= 0, got step={self.step} "
                f"unit={self.unit}")
        if self.duration < 1:
            raise ValueError(f"fault duration must be >= 1, "
                             f"got {self.duration}")

    def format(self) -> str:
        out = f"{self.kind}@{self.step}:unit={self.unit}"
        if self.kind == "restart":
            if self.factor != 0.0:
                out += f":delay={self.factor:g}"
            return out
        if self.factor != 2.0:
            out += f":factor={self.factor:g}"
        if self.duration != 1:
            out += f":duration={self.duration}"
        if self.kind == "corrupt" and self.sigma != 0.01:
            out += f":sigma={self.sigma:g}"
        return out


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, hashable set of fault events + the corruption seed.

    ``parse``/``format`` round-trip the compact string form
    (semicolon-joined events, ``kind@step:unit=U[:factor=F]
    [:duration=D][:sigma=S]``) so the same schedule travels through
    AlgoConfig, TrainSettings, JobSpec and CI unchanged.
    """

    events: tuple[FaultEvent, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, text: Optional[str], seed: int = 0) -> "FaultSchedule":
        if not text:
            return cls((), seed)
        events = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            head, _, rest = part.partition(":")
            kind, at, step = head.partition("@")
            if not at or not step:
                raise ValueError(
                    f"fault event {part!r} lacks '@step' — the form is "
                    "kind@step:unit=U[:factor=F][:duration=D][:sigma=S]")
            kw: dict[str, Any] = {"kind": kind, "step": int(step)}
            if kind == "restart":
                kw["factor"] = 0.0      # restart delay defaults to 0 s
            for item in filter(None, rest.split(":")):
                k, eq, v = item.partition("=")
                if not eq:
                    raise ValueError(
                        f"fault field {item!r} in {part!r} is not key=value")
                if k in ("unit", "step", "duration"):
                    kw[k] = int(v)
                elif k in ("factor", "sigma"):
                    kw[k] = float(v)
                elif k == "delay" and kind == "restart":
                    kw["factor"] = float(v)
                else:
                    raise ValueError(
                        f"unknown fault field {k!r} in {part!r}; fields are "
                        "unit/factor/duration/sigma (delay, for restart)")
            if "unit" not in kw:
                raise ValueError(f"fault event {part!r} lacks unit=")
            events.append(FaultEvent(**kw))
        return cls(tuple(events), seed)

    def format(self) -> str:
        return ";".join(e.format() for e in self.events)

    @property
    def kinds(self) -> frozenset:
        return frozenset(e.kind for e in self.events)


def as_schedule(faults, seed: int = 0) -> Optional[FaultSchedule]:
    """Normalize a CLI string / FaultSchedule / None to a schedule (None
    when there is nothing to inject)."""
    if faults is None:
        return None
    if isinstance(faults, FaultSchedule):
        return faults if faults.events else None
    sched = FaultSchedule.parse(faults, seed)
    return sched if sched.events else None


class FaultInjector:
    """Pure lookups over a ``FaultSchedule``. Stateless: every method is
    a function of (schedule, unit, step) only, so replay is exact."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule

    def _events(self, kind: str, unit: int) -> list[FaultEvent]:
        return [e for e in self.schedule.events
                if e.kind == kind and e.unit == unit]

    def killed_at(self, unit: int, attempt: int = 0) -> Optional[int]:
        """The step spawn generation ``attempt`` of ``unit`` dies at:
        the (attempt+1)-th scheduled kill, in step order. None when the
        schedule runs out of kills — that generation survives."""
        steps = sorted(e.step for e in self._events("kill", unit))
        return steps[attempt] if attempt < len(steps) else None

    def is_killed(self, unit: int, step: int, attempt: int = 0) -> bool:
        at = self.killed_at(unit, attempt)
        return at is not None and step >= at

    def restart_delay(self, unit: int, attempt: int = 0) -> Optional[float]:
        """Scheduled-respawn authorization for the death of spawn
        generation ``attempt``: the (attempt+1)-th restart event's delay
        (seconds), or None when none is scheduled (the supervisor then
        falls back to its budget, or gives up)."""
        events = sorted(self._events("restart", unit), key=lambda e: e.step)
        return events[attempt].factor if attempt < len(events) else None

    def restart_units(self, step: int) -> tuple[int, ...]:
        """Units with a restart event at exactly ``step`` — the shard
        driver's join directives (a restart for a non-live unit joins it
        mid-run)."""
        return tuple(sorted({e.unit for e in self.schedule.events
                             if e.kind == "restart" and e.step == step}))

    def should_drop(self, unit: int, step: int, attempt: int = 0) -> bool:
        """Whether delivery ``attempt`` (0-based) of the unit's push at
        ``step`` is lost. ``duration`` consecutive attempts fail, so a
        retrying pusher gets through on attempt ``duration`` — or never,
        if it gives up first."""
        return any(e.step == step and attempt < e.duration
                   for e in self._events("drop", unit))

    def straggle_factor(self, unit: int, step: int) -> float:
        """Compound slowdown (>= 1.0) active at ``step``."""
        f = 1.0
        for e in self._events("straggle", unit):
            if e.step <= step < e.step + e.duration:
                f *= max(e.factor, 1.0)
        return f

    def delay(self, unit: int, step: int) -> float:
        """Extra seconds added to the unit's leg at ``step``."""
        return sum(e.factor for e in self._events("delay", unit)
                   if e.step == step)

    def corrupt(self, tree: Any, unit: int, step: int) -> Any:
        """The unit's pushed value at ``step`` with scheduled corruption
        applied: gaussian noise of the event's ``sigma``, seeded by
        (schedule.seed, unit, step) — the SAME noise on every replay, and
        the reference's noise bit for bit (numpy draws it in f32, leaf by
        leaf in flatten order; it is cast to the leaf's dtype and device
        before the add; non-float leaves are left alone)."""
        events = [e for e in self._events("corrupt", unit) if e.step == step]
        if not events:
            return tree
        rng = np.random.default_rng((self.schedule.seed, unit, step))
        sigma = sum(e.sigma for e in events)

        def noisy(leaf):
            if not leaf.is_floating_point():
                return leaf
            noise = rng.standard_normal(tuple(leaf.shape), dtype=np.float32) * sigma
            return leaf + torch.from_numpy(noise).to(leaf.device, leaf.dtype)

        return tree_map(noisy, tree)

    def active(self, unit: int, step: int) -> bool:
        """Whether ANY event touches this (unit, step) — cheap guard for
        hot loops."""
        for e in self.schedule.events:
            if e.unit != unit:
                continue
            if e.kind in ("straggle",):
                if e.step <= step < e.step + e.duration:
                    return True
            elif e.kind == "kill":
                if step >= e.step:
                    return True
            elif e.kind == "restart":
                continue    # supervisor/driver directive, not a data fault
            elif e.step == step:
                return True
        return False


def injector(faults, seed: int = 0) -> Optional[FaultInjector]:
    """``as_schedule`` + wrap: None when there is nothing to inject."""
    sched = as_schedule(faults, seed)
    return FaultInjector(sched) if sched is not None else None


def delivery_time(inj: Optional[FaultInjector], unit: int, step: int,
                  at: float, *, retries: int = 2,
                  backoff: float = 0.05) -> Optional[float]:
    """When the unit's push at ``step`` actually lands, given the
    retry/backoff policy: attempt k fires ``backoff * 2**(k-1)`` after
    attempt k-1 (doubling backoff). Returns None when every attempt
    (1 initial + ``retries``) is dropped — the push is lost for good."""
    if inj is None:
        return at
    for attempt in range(retries + 1):
        if not inj.should_drop(unit, step, attempt):
            return at
        at += backoff * (2 ** attempt)
    return None
