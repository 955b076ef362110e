"""Process supervision for the multi-process PS tier
(``repro/launch/supervisor.py``; the paper's §8 LSF auto-restart role,
owned explicitly).

``Supervisor`` watches the spawned worker / server processes of one job.
A clean exit (code 0) finishes the unit; an abnormal exit (e.g. 137, the
SIGKILL the fault schedule lands) is answered one of three ways, in
priority order:

  scheduled   the fault schedule carries a ``restart@step:unit=U[:delay]``
              event for this spawn generation (``FaultInjector
              .restart_delay(unit, attempt)``: generation a's death
              consults the (a+1)-th restart event): respawn after that
              delay WITHOUT charging the restart budget, so chaos
              scripts replay deterministically
  budget      the ``RestartPolicy`` budget has headroom: respawn after
              exponential backoff (``backoff * factor**used``, capped)
              and charge one restart
  give up     no schedule, no budget: the unit stays down (eviction).
              If a budget existed and is now spent the unit is marked
              EXHAUSTED and the job must fail loudly (launch/run_local.py
              raises ``JobFailed`` with the full exit-code history).

Every respawn bumps the unit's ``attempt`` (shipped to the child as
REPRO_ATTEMPT): kills are generation-indexed in core/faults.py, the
worker resumes from its parked PS state, and a server restores its
latest durable snapshot. ``on_respawn`` fires just before the new spawn
(run_local stashes the dying generation's metrics file there so the
curves merge instead of overwriting).

Host logic only, transport-agnostic and clock-injectable: ``spawn``
takes the Unit and returns a process-like object (``poll() ->
Optional[int]``), so tests drive it with fakes and a fake clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass(frozen=True)
class RestartPolicy:
    """Per-unit restart budget + exponential backoff."""

    max_restarts: int = 0
    backoff: float = 0.05
    backoff_factor: float = 2.0
    max_backoff: float = 2.0

    def delay(self, used: int) -> float:
        return min(self.backoff * self.backoff_factor ** used,
                   self.max_backoff)


@dataclass
class Unit:
    """One supervised process slot (stable across respawns)."""

    name: str
    role: str                   # "worker" | "server"
    unit: int                   # fault-schedule unit id (rank)
    proc: Any
    attempt: int = 0
    used_budget: int = 0
    finished: bool = False
    gave_up: bool = False
    exhausted: bool = False
    exit_codes: list = field(default_factory=list)


class JobFailed(RuntimeError):
    """A unit exhausted its restart budget; carries the partial result."""

    def __init__(self, message: str, result: Any = None):
        super().__init__(message)
        self.result = result


class Supervisor:
    """Watch, respawn (schedule- or budget-driven), report."""

    def __init__(self, spawn: Callable[[Unit], Any], *,
                 policy: Optional[RestartPolicy] = None,
                 worker_injector=None, server_injector=None,
                 on_respawn: Optional[Callable[[Unit], None]] = None,
                 clock=time.monotonic, sleep=time.sleep,
                 poll_interval: float = 0.05):
        self.spawn = spawn
        self.policy = policy or RestartPolicy()
        self.worker_injector = worker_injector
        self.server_injector = server_injector
        self.on_respawn = on_respawn
        self.clock = clock
        self.sleep = sleep
        self.poll_interval = poll_interval
        self.units: dict[str, Unit] = {}
        self.respawns: list[dict] = []

    # -- registration --------------------------------------------------------
    def register(self, name: str, proc: Any, *, role: str = "worker",
                 unit: int = 0) -> Unit:
        if role not in ("worker", "server"):
            raise ValueError(f"role must be worker/server, got {role!r}")
        u = Unit(name=name, role=role, unit=unit, proc=proc)
        self.units[name] = u
        return u

    def procs(self) -> list[Any]:
        return [u.proc for u in self.units.values()]

    # -- decision ------------------------------------------------------------
    def _injector_for(self, u: Unit):
        return (self.worker_injector if u.role == "worker"
                else self.server_injector)

    def _decide(self, u: Unit) -> Optional[tuple[float, bool]]:
        """(respawn delay, scheduled?) — or None to give up. Death of
        spawn generation ``u.attempt`` consults the (attempt+1)-th
        restart event; the budget is the fallback."""
        inj = self._injector_for(u)
        if inj is not None:
            delay = inj.restart_delay(u.unit, u.attempt)
            if delay is not None:
                return float(delay), True
        if u.used_budget < self.policy.max_restarts:
            delay = self.policy.delay(u.used_budget)
            u.used_budget += 1
            return delay, False
        if self.policy.max_restarts > 0:
            u.exhausted = True
        return None

    def _handle_exit(self, u: Unit, rc: int) -> None:
        u.exit_codes.append(rc)
        if rc == 0:
            u.finished = True
            return
        died = self.clock()
        decision = self._decide(u)
        if decision is None:
            u.finished = True
            u.gave_up = True
            return
        delay, scheduled = decision
        if delay > 0:
            self.sleep(delay)
        if self.on_respawn is not None:
            self.on_respawn(u)
        u.attempt += 1
        u.proc = self.spawn(u)
        self.respawns.append({
            "name": u.name, "role": u.role, "unit": u.unit,
            "attempt": u.attempt, "exit_code": rc,
            "scheduled": scheduled, "gap_s": self.clock() - died,
        })

    # -- the loop ------------------------------------------------------------
    def supervise(self, *, timeout: float = 600.0) -> dict:
        """Poll until every WORKER unit finishes (servers idle until the
        job's shutdown RPC; they are still respawned on abnormal death).
        Returns the supervision report."""
        deadline = self.clock() + timeout
        timed_out = False
        while True:
            for u in list(self.units.values()):
                if u.finished:
                    continue
                rc = u.proc.poll()
                if rc is not None:
                    self._handle_exit(u, rc)
            workers = [u for u in self.units.values() if u.role == "worker"]
            if all(u.finished for u in workers):
                break
            if self.clock() >= deadline:
                timed_out = True
                break
            self.sleep(self.poll_interval)
        return self.report(timed_out=timed_out)

    def report(self, *, timed_out: bool = False) -> dict:
        return {
            "respawns": list(self.respawns),
            "exit_codes": {n: (u.exit_codes[-1] if u.exit_codes else None)
                           for n, u in self.units.items()},
            "exit_history": {n: list(u.exit_codes)
                             for n, u in self.units.items()},
            "attempts": {n: u.attempt for n, u in self.units.items()},
            "exhausted": sorted(n for n, u in self.units.items()
                                if u.exhausted),
            "gave_up": sorted(n for n, u in self.units.items()
                              if u.gave_up),
            "timed_out": timed_out,
        }
