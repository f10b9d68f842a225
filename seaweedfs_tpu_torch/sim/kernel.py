"""Deterministic discrete-event kernel for the macro simulation.

One thread, one event heap, one virtual clock.  Actor logic is written
as plain generator coroutines that ``yield`` effects:

    yield 0.005                 # sleep 5 virtual milliseconds
    reply = yield future        # wait for a Future (e.g. an RPC)
    results = yield futures     # a list waits for ALL of them

The kernel pops events in (time, sequence) order, so two events at the
same instant fire in the order they were scheduled — there is no other
source of ordering anywhere, which is what makes a run bit-reproducible
from its seed.  While ``run_until`` executes, the kernel installs
itself as the process clock (utils/clockctl.py), so the REAL resilience
and QoS classes the actors embed (CircuitBreaker open windows, token
bucket refills, pressure decay) elapse in virtual time.

Wall-clock compression is the whole point: a 10-minute incident over
100 actors replays in seconds because idle virtual time costs nothing.

Every externally meaningful transition is appended to ``log`` as a
``(time, actor, event, detail)`` tuple; ``log_hash()`` digests it for
the same-seed-same-run acceptance check.

The port's copy of seaweedfs_tpu/sim/kernel.py. It imports nothing of that
package.
"""

from __future__ import annotations

import hashlib
import heapq
import random
from typing import Callable, Iterator, Optional

from seaweedfs_tpu_torch.utils import clockctl


class SimError(ConnectionError):
    """Transport-level failure inside the sim (timeout, reset, crashed
    peer).  Subclasses ConnectionError so real code under test (breaker
    record paths, retry classification) treats it like the real thing."""


class SimShed(Exception):
    """A simulated 503 from an admission gate; carries Retry-After."""

    def __init__(self, retry_after: float = 0.2, reason: str = "limit"):
        self.retry_after = retry_after
        self.reason = reason
        super().__init__(f"shed:{reason}")


class Future:
    """Single-assignment result cell; generators wait on it by yielding
    it.  Resolving twice is a no-op (a timeout and a late reply race —
    first one wins, deterministically by heap order)."""

    __slots__ = ("done", "value", "exc", "_waiters")

    def __init__(self):
        self.done = False
        self.value = None
        self.exc: Optional[BaseException] = None
        self._waiters: list = []  # _Task objects

    def result(self):
        if self.exc is not None:
            raise self.exc
        return self.value


class _Task:
    __slots__ = ("gen", "future")

    def __init__(self, gen: Iterator, future: Future):
        self.gen = gen
        self.future = future


class _AllWaiter:
    """Adapter: resumes its task once every sub-future is done, with
    the futures themselves (caller inspects .exc per slot)."""

    __slots__ = ("task", "futures", "remaining")

    def __init__(self, task: _Task, futures: list):
        self.task = task
        self.futures = futures
        self.remaining = sum(1 for f in futures if not f.done)


class SimKernel:
    def __init__(self, seed: int = 0):
        self.now = 0.0
        self.seed = seed
        self.rng = random.Random(seed)
        self._heap: list = []
        self._seq = 0
        self.log: list[tuple] = []
        self.events_processed = 0

    # ---- scheduling ----
    def schedule(self, delay: float, fn: Callable, *args) -> None:
        self._seq += 1
        # inline clamp: max() is a builtin call on the hottest path in
        # the sim (every event goes through here at least once)
        heapq.heappush(
            self._heap,
            (self.now + delay if delay > 0.0 else self.now,
             self._seq, fn, args))

    def spawn(self, gen: Iterator) -> Future:
        """Start a coroutine now; returns a Future for its return
        value (StopIteration.value) or its escaping exception."""
        fut = Future()
        task = _Task(gen, fut)
        self.schedule(0.0, self._advance, task, None, None)
        return fut

    def resolve(self, fut: Future, value=None,
                exc: Optional[BaseException] = None) -> None:
        if fut.done:
            return  # late reply lost the race against a timeout
        fut.done = True
        fut.value = value
        fut.exc = exc
        waiters, fut._waiters = fut._waiters, []
        for w in waiters:
            if isinstance(w, _AllWaiter):
                w.remaining -= 1
                if w.remaining == 0:
                    self.schedule(0.0, self._advance, w.task,
                                  w.futures, None)
            else:
                self.schedule(0.0, self._advance, w, fut.value, fut.exc)

    # ---- coroutine stepping ----
    def _advance(self, task: _Task, value, exc) -> None:
        try:
            if exc is not None:
                eff = task.gen.throw(exc)
            else:
                eff = task.gen.send(value)
        except StopIteration as si:
            self.resolve(task.future, si.value)
            return
        except BaseException as e:
            self.resolve(task.future, exc=e)
            return
        if isinstance(eff, (int, float)):
            self.schedule(float(eff), self._advance, task, None, None)
        elif isinstance(eff, Future):
            if eff.done:
                self.schedule(0.0, self._advance, task, eff.value, eff.exc)
            else:
                eff._waiters.append(task)
        elif isinstance(eff, list):
            waiter = _AllWaiter(task, eff)
            if waiter.remaining == 0:
                self.schedule(0.0, self._advance, task, eff, None)
            else:
                for f in eff:
                    if not f.done:
                        f._waiters.append(waiter)
        else:  # pragma: no cover - catches actor-code bugs loudly
            self.resolve(task.future,
                         exc=TypeError(f"bad sim effect {eff!r}"))

    # ---- run loop ----
    def run_until(self, t_end: float, max_events: int = 50_000_000) -> None:
        """Advance virtual time to t_end, firing every due event, with
        the virtual clock installed process-wide for the duration."""
        with clockctl.install(lambda: self.now):
            # hot loop: several hundred thousand iterations per
            # incident — keep the pop and the event counter in locals
            # (heapq.heappop and self.events_processed attribute
            # traffic are measurable at this volume; see PERF.md)
            heap = self._heap
            heappop = heapq.heappop
            n = self.events_processed
            try:
                while heap and heap[0][0] <= t_end:
                    t, _, fn, args = heappop(heap)
                    self.now = t
                    fn(*args)
                    n += 1
                    if n > max_events:
                        raise RuntimeError("sim event budget exceeded "
                                           "(runaway schedule?)")
            finally:
                self.events_processed = n
            self.now = t_end

    # ---- event log ----
    def note(self, actor: str, event: str, detail: str = "") -> None:
        self.log.append((round(self.now, 6), actor, event, detail))

    def log_hash(self) -> str:
        h = hashlib.sha256()
        for entry in self.log:
            h.update(repr(entry).encode())
        return h.hexdigest()
