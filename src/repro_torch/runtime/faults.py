"""Deterministic, seeded fault injection for the serving engine.

Chaos testing with ad-hoc thread kills and ``random.random()`` hooks is
unreproducible: a red run tells you *that* something broke, never how to
see it again.  This module makes every fault scenario a *value*:

``FaultPlan``
    A frozen, JSON-round-trippable record of exactly which faults fire
    where — lane crashes at execution k, transient kernel exceptions,
    slow-lane latency multipliers, and submit storms.  Plans either
    enumerate faults explicitly or are drawn deterministically from a seed
    (``FaultPlan.sample``), so a nightly chaos run that fails can be
    replayed bit-identically from the seed echoed in its log.

``FaultInjector``
    The runtime object a ``ServingEngine`` consults.  It keeps one
    execution counter per lane (thread-safe — the threaded engine calls it
    from worker threads mid-flight) and raises ``InjectedCrash`` /
    ``InjectedTransient`` at exactly the planned executions:

      * a **crash** at execution k raises on *every* retry attempt of that
        one execution, so the lane's retry budget exhausts and the lane
        dies (the supervisor may then restart it; execution k+1 after the
        restart succeeds — a crash fires once, not forever);
      * a **transient** at execution k raises only on the first attempt,
        so the retry budget absorbs it;
      * a **slow lane** multiplies measured service time (the threaded
        engine really sleeps the difference; the virtual engine scales the
        committed service time — deterministic either way);
      * a **submit storm** is trace-level, not execution-level: callers
        (benchmarks, chaos tests) read ``FaultPlan.storm_arrivals()`` and
        submit that burst on top of their base trace.  The engine never
        fabricates requests.

The conservation invariant — every submitted request resolves exactly once
(result, SLO/deadline/cancel error, or queue-full error) — must hold under
*any* plan; ``tests/test_serving_faults.py`` property-tests it over
seed-sampled plans.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["InjectedFault", "InjectedCrash", "InjectedTransient",
           "FaultPlan", "FaultInjector"]


class InjectedFault(RuntimeError):
    """Base class for planned faults (distinguishes chaos from real bugs)."""


class InjectedCrash(InjectedFault):
    """A planned lane crash: raised on every attempt of one execution so
    the retry budget exhausts and the lane dies."""


class InjectedTransient(InjectedFault):
    """A planned transient: raised on the first attempt only, absorbed by
    the retry budget."""


@dataclass(frozen=True)
class FaultPlan:
    """One reproducible chaos scenario.

    ``crashes`` / ``transients`` are ``(lane, execution_k)`` pairs — the
    k-th micro-batch execution dispatched to that lane (0-based, counted
    across restarts, retries of one execution count once).  ``slow_lanes``
    is ``(lane, multiplier)`` with multiplier >= 1.  ``storms`` is
    ``(at_s, n_requests)`` — a burst of n extra submissions at trace time
    ``at_s`` (caller-level, see module docstring).  ``seed`` names the
    scenario (and, for ``sample``-drawn plans, fully determines it).
    """

    seed: int = 0
    crashes: Tuple[Tuple[int, int], ...] = ()
    transients: Tuple[Tuple[int, int], ...] = ()
    slow_lanes: Tuple[Tuple[int, float], ...] = ()
    storms: Tuple[Tuple[float, int], ...] = ()

    def __post_init__(self):
        for name in ("crashes", "transients"):
            for lane, k in getattr(self, name):
                if lane < 0 or k < 0:
                    raise ValueError(
                        f"{name} entries must be (lane >= 0, execution >= 0),"
                        f" got ({lane}, {k})")
        for lane, mult in self.slow_lanes:
            if lane < 0 or mult < 1.0:
                raise ValueError(
                    f"slow_lanes entries must be (lane >= 0, multiplier >= 1)"
                    f", got ({lane}, {mult})")
        for at_s, n in self.storms:
            if at_s < 0.0 or n < 1:
                raise ValueError(
                    f"storms entries must be (at_s >= 0, n >= 1), "
                    f"got ({at_s}, {n})")

    # -- seeded scenario generation ------------------------------------------
    @classmethod
    def sample(cls, seed: int, num_lanes: int, *, max_execution: int = 4,
               ) -> "FaultPlan":
        """Draw one random-but-reproducible plan from ``seed``.

        Per lane, independently: a crash at a random early execution with
        probability 1/2, a transient likewise, and a slowdown (x1.25-x2)
        with probability 1/3; plus 0-2 submit storms.  The same (seed,
        num_lanes, max_execution) always yields the identical plan — the
        nightly chaos job logs its seed precisely so a red run replays as
        ``FaultPlan.sample(seed=<logged>, num_lanes=...)``.
        """
        rng = np.random.default_rng(int(seed))
        crashes: List[Tuple[int, int]] = []
        transients: List[Tuple[int, int]] = []
        slow: List[Tuple[int, float]] = []
        for lane in range(int(num_lanes)):
            if rng.random() < 0.5:
                crashes.append((lane, int(rng.integers(0, max_execution))))
            if rng.random() < 0.5:
                transients.append((lane, int(rng.integers(0, max_execution))))
            if rng.random() < 1.0 / 3.0:
                slow.append((lane, float(1.25 + 0.75 * rng.random())))
        storms = tuple(
            (float(rng.uniform(0.0, 0.05)), int(rng.integers(4, 13)))
            for _ in range(int(rng.integers(0, 3))))
        return cls(seed=int(seed), crashes=tuple(crashes),
                   transients=tuple(transients), slow_lanes=tuple(slow),
                   storms=storms)

    def storm_arrivals(self) -> List[float]:
        """Flatten the storms into one sorted list of extra arrival times
        (n copies of each burst instant) for callers to submit on top of
        their base trace."""
        out: List[float] = []
        for at_s, n in self.storms:
            out.extend([float(at_s)] * int(n))
        return sorted(out)

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict (nested tuples listified)."""
        return {
            "seed": self.seed,
            "crashes": [list(c) for c in self.crashes],
            "transients": [list(t) for t in self.transients],
            "slow_lanes": [list(s) for s in self.slow_lanes],
            "storms": [list(s) for s in self.storms],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        """Inverse of ``to_dict``; unknown keys are a loud error."""
        d = dict(d)
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown FaultPlan field(s) {unknown}; valid: {sorted(known)}")
        kw: Dict[str, Any] = {"seed": int(d.get("seed", 0))}
        for name in ("crashes", "transients", "slow_lanes", "storms"):
            kw[name] = tuple(tuple(e) for e in d.get(name, ()))
        return cls(**kw)


class FaultInjector:
    """Executes a ``FaultPlan`` against a running engine.

    Installed as the dispatcher's per-attempt fault hook (optionally
    chained with a user hook via ``chain``); ``latency_multiplier`` is the
    slow-lane query.  All state (per-lane execution counters, fired-fault
    accounting) is lock-protected — worker threads call ``on_execute``
    concurrently.
    """

    def __init__(self, plan: FaultPlan, num_lanes: int):
        self.plan = plan
        self._crashes: Dict[int, set] = {}
        self._transients: Dict[int, set] = {}
        for lane, k in plan.crashes:
            self._crashes.setdefault(int(lane), set()).add(int(k))
        for lane, k in plan.transients:
            self._transients.setdefault(int(lane), set()).add(int(k))
        self._slow = {int(lane): float(m) for lane, m in plan.slow_lanes}
        self._execs = [0] * int(num_lanes)
        self._current = [-1] * int(num_lanes)
        self._lock = threading.Lock()
        self.fired: Dict[str, int] = {"crash": 0, "transient": 0}

    def on_execute(self, lane: int, attempt: int) -> None:
        """Dispatcher fault hook: called before every execution attempt.
        Counts executions (attempt 0 opens a new one; retries re-test the
        same execution index) and raises the planned fault, if any."""
        with self._lock:
            if attempt == 0:
                self._current[lane] = self._execs[lane]
                self._execs[lane] += 1
            k = self._current[lane]
            crash = k in self._crashes.get(lane, ())
            transient = (attempt == 0
                         and k in self._transients.get(lane, ()))
            if crash:
                self.fired["crash"] += 1
            elif transient:
                self.fired["transient"] += 1
        if crash:
            raise InjectedCrash(
                f"planned crash: lane {lane} execution {k} "
                f"(FaultPlan seed={self.plan.seed})")
        if transient:
            raise InjectedTransient(
                f"planned transient: lane {lane} execution {k} "
                f"(FaultPlan seed={self.plan.seed})")

    def latency_multiplier(self, lane: int) -> float:
        """Service-time multiplier for ``lane`` (1.0 = full speed)."""
        return self._slow.get(int(lane), 1.0)

    def chain(self, hook: Optional[Callable[[int, int], None]]
              ) -> Callable[[int, int], None]:
        """Compose with a user fault hook (plan faults fire first)."""
        if hook is None:
            return self.on_execute

        def chained(lane: int, attempt: int) -> None:
            self.on_execute(lane, attempt)
            hook(lane, attempt)
        return chained

    def executions(self, lane: int) -> int:
        with self._lock:
            return self._execs[lane]
