"""Fault-tolerance supervisor: classified retry, escalation, survivor
prebuild (``repro.train.supervisor``, copied but for what a survivor build
holds).

* **classified retry**: ``Supervisor.run`` wraps an operation (a step, a
  checkpoint write) in bounded retry with exponential backoff. Failures are
  ``transient`` (I/O and timeout kinds: a repeat may succeed) or ``fatal``
  (programming and shape errors: fail fast). Every retry records a
  ``retry`` event through ``obs``, so a flaky disk shows in the trace.

* **straggler escalation**: ``note_straggler`` turns the
  ``StragglerMonitor``'s per-step flag into a policy: K consecutive flagged
  steps request a proactive checkpoint.

* **survivor prebuild**: ``SurvivorPrecompiler`` takes the build of a
  survivor mesh's program off the recovery path. The reference AOT-compiles
  a jitted step; the port's sharded step is eager, so there is nothing to
  compile ahead, and a build is what recovery would otherwise do first: the
  ``ft.plan_recovery`` decision, the mesh and its specs, and the step
  closure (``launch.train``'s ``_survivor_build``), done in a background
  thread while healthy steps run. ``get`` hands recovery the finished build
  (``PrecompiledProgram``); ``compile_s`` in ``launch.train``'s report is the wait
  for it that is left exposed.

Everything here is device-agnostic control flow; ``launch.train`` injects the
build as a thunk.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# Exception families the retry loop treats as transient: the operation
# may succeed if simply repeated (flaky disk, NFS hiccup, timeout).
# Everything else — ValueError, TypeError, KeyError, assertion — is a
# programming/shape error that retrying cannot fix.
TRANSIENT_EXCEPTIONS: Tuple[type, ...] = (OSError, IOError, TimeoutError,
                                          ConnectionError, BlockingIOError)


def classify(exc: BaseException) -> str:
    """``"transient"`` or ``"fatal"`` — the retry decision for ``exc``.

    KeyboardInterrupt/SystemExit are always fatal (never swallow an
    operator's ctrl-C behind a backoff sleep).
    """
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return "fatal"
    if isinstance(exc, TRANSIENT_EXCEPTIONS):
        return "transient"
    return "fatal"


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with a total wall-clock deadline.

    ``max_attempts`` counts *tries* (1 = no retry at all). Backoff for
    attempt i (1-indexed) is ``backoff_s * multiplier**(i-1)`` capped at
    ``max_backoff_s``; ``deadline_s`` bounds the total time spent inside
    one ``Supervisor.run`` call including sleeps (None = unbounded).
    """
    max_attempts: int = 4
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    deadline_s: Optional[float] = None

    def backoff_for(self, attempt: int) -> float:
        """Sleep before retrying after failed attempt ``attempt``."""
        return min(self.backoff_s * self.multiplier ** max(attempt - 1, 0),
                   self.max_backoff_s)


class RetryError(RuntimeError):
    """The retry budget (attempts or deadline) is exhausted; carries the
    last underlying exception as ``__cause__`` and the attempt count."""

    def __init__(self, op: str, attempts: int, why: str):
        super().__init__(f"{op}: gave up after {attempts} attempt(s) "
                         f"({why})")
        self.op = op
        self.attempts = attempts
        self.why = why


@dataclass
class Supervisor:
    """Runs operations under a RetryPolicy, reporting through repro.obs.

    ``recorder``/``metrics`` default to no-ops (the disabled Recorder /
    a private registry), so the supervisor is usable from tests and
    tools without the full obs stack. ``sleep`` is injectable so tests
    assert the backoff schedule without waiting it out.
    """
    policy: RetryPolicy = field(default_factory=RetryPolicy)
    recorder: Optional[object] = None
    metrics: Optional[object] = None
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    escalate_after: int = 3         # K consecutive straggler flags
    _consecutive_flags: int = field(default=0, repr=False)
    retries: int = field(default=0, repr=False)
    proactive_checkpoints: int = field(default=0, repr=False)

    def _event(self, name: str, **attrs) -> None:
        if self.recorder is not None:
            self.recorder.event(name, **attrs)

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    # -- classified retry ----------------------------------------------------
    def run(self, op: str, fn: Callable[[], Any]) -> Any:
        """Execute ``fn`` under the retry policy.

        Transient failures back off and retry (a ``retry`` event + a
        ``retries/<op>`` counter per occurrence); fatal failures re-raise
        immediately. Exhausting attempts or the deadline raises
        ``RetryError`` with the last failure as ``__cause__``.
        """
        t0 = self.clock()
        last: Optional[BaseException] = None
        for attempt in range(1, self.policy.max_attempts + 1):
            try:
                return fn()
            except BaseException as e:
                kind = classify(e)
                if kind == "fatal":
                    self._event("fatal", op=op, attempt=attempt,
                                error=f"{type(e).__name__}: {e}")
                    self._count(f"fatal/{op}")
                    raise
                last = e
            backoff = self.policy.backoff_for(attempt)
            elapsed = self.clock() - t0
            deadline = self.policy.deadline_s
            exhausted = attempt >= self.policy.max_attempts
            over_deadline = (deadline is not None
                             and elapsed + backoff > deadline)
            self.retries += 1
            self._count(f"retries/{op}")
            self._event("retry", op=op, attempt=attempt,
                        error=f"{type(last).__name__}: {last}",
                        backoff_s=(0.0 if exhausted or over_deadline
                                   else backoff),
                        will_retry=not (exhausted or over_deadline))
            if exhausted:
                raise RetryError(op, attempt,
                                 "max attempts reached") from last
            if over_deadline:
                raise RetryError(op, attempt,
                                 f"deadline {deadline}s exceeded") from last
            self.sleep(backoff)
        raise AssertionError("unreachable")          # pragma: no cover

    # -- straggler escalation ------------------------------------------------
    def note_straggler(self, step: int, flagged: bool) -> bool:
        """Feed the monitor's per-step flag; True = take a proactive
        checkpoint now (K-th consecutive flag; the streak then resets so
        one persistent straggler requests one checkpoint, not one per
        step)."""
        if not flagged:
            self._consecutive_flags = 0
            return False
        self._consecutive_flags += 1
        if self._consecutive_flags < max(self.escalate_after, 1):
            return False
        self._consecutive_flags = 0
        self.proactive_checkpoints += 1
        self._count("proactive_checkpoints")
        self._event("proactive_checkpoint", step=int(step),
                    consecutive_flags=int(max(self.escalate_after, 1)))
        return True


def pow2_floor(n: int) -> int:
    n = int(n)
    if n <= 1:
        return max(n, 1)
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


@dataclass
class PrecompiledProgram:
    """One survivor mesh's built program plus everything the recovery path
    needs to swap it in without re-deriving placement."""
    key: Tuple
    plan: object                      # ft.RecoveryPlan
    bundle: Tuple                     # the caller's (axes, path, ...)
    compile_s: float


class SurvivorPrecompiler:
    """Background builds of candidate survivor-mesh programs.

    The caller submits one build thunk per pow2-floored survivor count;
    a single worker thread drains the queue (one build at a time — the
    point is to hide the latency behind healthy steps, not to thrash the
    host). ``get(n_survivors)`` returns the ``PrecompiledProgram`` for
    ``pow2_floor(n_survivors)``, optionally blocking until the build
    lands (a recovery in steady state hits a finished entry; ``block``
    covers the race where failure arrives mid-compile).
    """

    def __init__(self, recorder: Optional[object] = None,
                 metrics: Optional[object] = None):
        self._done: Dict[Tuple, PrecompiledProgram] = {}
        self._errors: Dict[Tuple, BaseException] = {}
        self._pending: List[Tuple[Tuple, Callable]] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._recorder = recorder
        self._metrics = metrics

    def submit(self, key: Tuple, build: Callable[[], Tuple[object, Tuple]]
               ) -> None:
        """Queue ``build`` (returns ``(plan, bundle)``) under ``key``.
        Idempotent per key; starts the worker on first use."""
        with self._cv:
            if (key in self._done or key in self._errors
                    or any(k == key for k, _ in self._pending)):
                return
            self._pending.append((key, build))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        while True:
            with self._cv:
                if not self._pending:
                    return
                key, build = self._pending.pop(0)
            t0 = time.perf_counter()
            try:
                plan, bundle = build()
                prog = PrecompiledProgram(key=key, plan=plan, bundle=bundle,
                                          compile_s=time.perf_counter() - t0)
                with self._cv:
                    self._done[key] = prog
                    self._cv.notify_all()
                if self._metrics is not None:
                    self._metrics.gauge(
                        f"precompile/{'_'.join(map(str, key))}_s").set(
                        prog.compile_s)
                if self._recorder is not None:
                    self._recorder.event("precompile", key=list(key),
                                         compile_s=prog.compile_s)
            except BaseException as e:            # keep the worker alive
                with self._cv:
                    self._errors[key] = e
                    self._cv.notify_all()
                if self._recorder is not None:
                    self._recorder.event(
                        "precompile_failed", key=list(key),
                        error=f"{type(e).__name__}: {e}")

    def get(self, n_survivors: int, *, extra: Tuple = (),
            block: bool = False, timeout: Optional[float] = None
            ) -> Optional[PrecompiledProgram]:
        """The built program for this survivor count, or None (not
        submitted / failed / still building and ``block`` is False)."""
        key = (pow2_floor(n_survivors),) + tuple(extra)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if key in self._done:
                    return self._done[key]
                if key in self._errors:
                    return None
                queued = any(k == key for k, _ in self._pending)
                compiling = (self._thread is not None
                             and self._thread.is_alive())
                if not block or not (queued or compiling):
                    return None
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return None
                self._cv.wait(timeout=wait if wait is not None else 0.5)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"compiled": sorted(map(list, self._done)),
                    "failed": sorted(map(list, self._errors)),
                    "pending": [list(k) for k, _ in self._pending],
                    "compile_s": {
                        "_".join(map(str, k)): round(p.compile_s, 3)
                        for k, p in self._done.items()}}
