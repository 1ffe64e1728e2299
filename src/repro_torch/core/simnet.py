"""Minimal deterministic discrete-event scheduler for the serving engine.

The subset of the JAX package's simulator that :class:`BatchEngine` needs:
one-shot :class:`Event`\\ s, generator-driven :class:`Process`\\ es, and a
:class:`Sim` loop with the same tie-breaking (a monotone sequence number),
so admission stays FIFO with direct hand-off.  No network model and no
sanitizer.

Process protocol (SimPy-like):
    * ``yield <float>``          sleep for that many seconds
    * ``yield Event``            wait until the event succeeds (or re-raises)
    * ``yield Process``          wait for a child process to finish
    * ``return value``           completes the process; parents receive value
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple


class SimError(Exception):
    pass


class Event:
    """One-shot event; processes can wait on it."""

    __slots__ = ("sim", "triggered", "failed", "value", "_waiters")

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self.triggered = False
        self.failed = False
        self.value: Any = None
        self._waiters: List[Callable[["Event"], None]] = []

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            return self
        self.triggered = True
        self.value = value
        for w in self._waiters:
            self.sim._schedule(0.0, w, self)
        self._waiters.clear()
        return self

    def fail(self, exc: BaseException) -> "Event":
        if self.triggered:
            return self
        self.triggered = True
        self.failed = True
        self.value = exc
        for w in self._waiters:
            self.sim._schedule(0.0, w, self)
        self._waiters.clear()
        return self

    def _add_waiter(self, cb: Callable[["Event"], None]) -> None:
        if self.triggered:
            self.sim._schedule(0.0, cb, self)
        else:
            self._waiters.append(cb)


class Process(Event):
    """Drives a generator; completion is an Event carrying the return value."""

    __slots__ = ("_gen",)

    def __init__(self, sim: "Sim", gen: Generator):
        super().__init__(sim)
        self._gen = gen
        sim._schedule(0.0, self._resume, None)

    def _resume(self, evt: Optional[Event]) -> None:
        if self.triggered:
            return
        try:
            if isinstance(evt, Event) and evt.failed:
                item = self._gen.throw(evt.value)
            else:
                item = self._gen.send(evt.value if isinstance(evt, Event) else evt)
        except StopIteration as stop:
            self.succeed(stop.value)
            return
        except BaseException as exc:  # noqa: BLE001 - delivered to waiters
            self.fail(exc)
            return
        self._dispatch(item)

    def _dispatch(self, item: Any) -> None:
        if isinstance(item, Event):
            item._add_waiter(self._resume)
        elif isinstance(item, (int, float)):
            self.sim._schedule(float(item), self._resume, None)
        else:  # pragma: no cover - programming error
            raise TypeError(f"process yielded unsupported item {item!r}")


class Sim:
    def __init__(self, seed: int = 0):
        # ``seed`` is kept for the JAX simulator's signature; nothing here
        # draws random numbers
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, Callable, Any]] = []
        self._seq = itertools.count()
        self._leak_checks: Dict[str, Callable[[], float]] = {}

    def _schedule(self, delay: float, fn: Callable, arg: Any) -> None:
        heapq.heappush(self._heap, (self.now + delay, next(self._seq), fn, arg))

    def event(self) -> Event:
        return Event(self)

    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    def run(self, until: Optional[float] = None) -> None:
        while self._heap:
            t, _, fn, arg = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            self.now = t
            fn(arg)
        if until is not None:
            self.now = max(self.now, until)

    def run_process(self, gen: Generator, until: float = 1e9) -> Any:
        """Run the loop until ``gen`` completes; returns its value or raises."""
        proc = self.process(gen)
        while self._heap and not proc.triggered:
            t, _, fn, arg = heapq.heappop(self._heap)
            if t > until:
                raise SimError(f"process did not complete before t={until}")
            self.now = t
            fn(arg)
        if not proc.triggered:
            raise SimError("deadlock: process blocked with empty event queue")
        if proc.failed:
            raise proc.value
        return proc.value

    def register_leak_check(self, name: str, fn: Callable[[], float]) -> None:
        """Install a named resource gauge (count of currently-held
        resources).  Re-registering a name replaces it."""
        self._leak_checks[name] = fn

    def leak_report(self) -> Dict[str, float]:
        return {name: fn() for name, fn in sorted(self._leak_checks.items())}
