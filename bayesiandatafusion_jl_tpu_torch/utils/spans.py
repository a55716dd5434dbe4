"""Spans and counters at the layer boundaries of the sweep and the set-up.

``span(name, sweep=None)`` marks one phase of a sweep:

- off (the default) it checks whether a recording is open and whether
  ``torch.profiler`` is on, and does nothing else;
- under an active ``torch.profiler`` it is a ``record_function`` range of
  that name, the sweep number its argument: the phases sit in the trace on
  the timeline of the device operations they launch, so each launch can be
  tied to the innermost span it was issued in (its correlation id), and
  each idle gap of the device to the span the host was in;
- under ``recording()`` it appends ``Span(name, parent, sweep, start_ns,
  end_ns)`` on ``time.perf_counter_ns`` to the open ``Record``, in memory.

``timed(name)`` marks one phase of the set-up: it always measures its host
seconds (``.seconds``, which the set-up's attributes hold:
``GramianPlan.seconds``, ``CompiledProblem.build_seconds`` and
``layout_seconds``, ``feat_seconds``, the kernel builds' seconds), and is
emitted or recorded as ``span`` is.  The phases of the newest set-up stay
readable after it without a recording (``setup_seconds``).

The kernel wrappers' ``.launches`` and the plain versions' ``.calls``
counters register here (``counter``), as do the gather assembly's
(``assemble_precision.direct_rows`` and ``.overflow_rows``, the rows a
destination map stores at their instance and through the overflow, and
``_segment_sum.calls``) and the beta draw's (``bucketed_spmm.calls``,
``dual_solve.calls``, ``block_cg.calls`` and ``.iterations``,
``chol_solve.calls``); a ``Record`` holds their change over the recorded
stretch beside the recorded spans' entry counts.  A phase replayed from a
CUDA graph (``utils/graphs.py``) runs no Python: the spans inside it are
entered at its capture alone, and its replays advance the counters by what
the capture counted (``advance``).

The names: ``bdf.window``, ``bdf.fetch``, ``bdf.randoms``, ``bdf.sweep``;
per entity ``bdf.e{i}.beta`` (inside it ``bdf.beta_rhs``,
``bdf.beta_solve``, ``bdf.beta_fwd`` where the solver does not return X
beta, and ``bdf.lambda_beta``), ``.hyper``, ``.precision`` (with
``bdf.r{ri}m{m}.dense`` for each dense contribution, inside it
``bdf.ytab``, ``bdf.contract`` and ``bdf.expand``, and ``bdf.e{i}.buckets``
for the gather assembly, inside it ``bdf.e{i}.overflow`` where a
destination map sums overflow slots) and ``.draw`` (above K = 96 with
``bdf.k5``, ``bdf.panels`` and ``bdf.solves``); per relation
``bdf.r{ri}.alpha`` and ``bdf.r{ri}.predict``; the set-up's under
``bdf.build``: ``.plan``, ``.store``, ``.layouts``, ``.acc_plan``,
``.dest_map``, ``.features`` (its ``.operand``, ``.gram``, ``.eigh``,
``.nystrom``, ``.ftf``), and ``.nvcc`` and ``.native`` where they compile.
Spans are entered from one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from torch.autograd import _profiler_enabled
from torch.profiler import record_function


@dataclasses.dataclass
class Span:
    """One recorded span: ``parent`` is the index of the span it opened in
    (``Record.spans``), -1 at the top; ``sweep`` its own or its parent's."""
    name: str
    parent: int
    sweep: Optional[int]
    start_ns: int
    end_ns: int = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Record:
    """What ``recording()`` gathers: the spans in the order they opened,
    and, once the stretch has ended, ``counters``: each span name's entry
    count and each registered counter's change."""
    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    _open: List[int] = dataclasses.field(default_factory=list)

    def _enter(self, name: str, sweep: Optional[int], t_ns: int) -> int:
        parent = self._open[-1] if self._open else -1
        if sweep is None and parent >= 0:
            sweep = self.spans[parent].sweep
        self.spans.append(Span(name, parent, sweep, t_ns))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def _exit(self, i: int, t_ns: int) -> None:
        self.spans[i].end_ns = t_ns
        self._open.pop()

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """{span name: (entries, host seconds)}."""
        out: Dict[str, Tuple[int, float]] = {}
        for s in self.spans:
            n, secs = out.get(s.name, (0, 0.0))
            out[s.name] = (n + 1, secs + s.seconds)
        return out


_record: Optional[Record] = None
_counters: Dict[str, Tuple[object, str]] = {}
# the open set-up phases (outermost first) and, by the name of each
# outermost one, the (name, seconds) of its newest run and its phases
_timed_open: List[str] = []
_setup: Dict[str, List[Tuple[str, float]]] = {}


# the context of a span while nothing listens
_OFF = contextlib.nullcontext()


class _On:
    __slots__ = ("name", "sweep", "_rf", "_rec", "_i")

    def __init__(self, name: str, sweep: Optional[int]):
        self.name, self.sweep = name, sweep
        self._rf = self._rec = self._i = None

    def __enter__(self):
        if _record is not None:
            self._rec = _record
            self._i = _record._enter(self.name, self.sweep,
                                     time.perf_counter_ns())
        if _profiler_enabled():
            self._rf = record_function(
                self.name, None if self.sweep is None else str(self.sweep))
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._rec is not None:
            self._rec._exit(self._i, time.perf_counter_ns())
        return None


def span(name: str, sweep: Optional[int] = None):
    """The context of one phase of a sweep (the module's docstring)."""
    if _record is None and not _profiler_enabled():
        return _OFF
    return _On(name, sweep)


class timed:
    """One phase of the set-up: ``with timed(name) as t:``, then
    ``t.seconds``; emitted or recorded as ``span`` is, and kept among the
    newest set-up's phases (``setup_seconds``)."""

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._rf = self._i = self._rec = None
        self._t0 = 0

    def __enter__(self):
        if not _timed_open:
            _setup[self.name] = []
        _timed_open.append(self.name)
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        if _record is not None:
            self._rec = _record
            self._i = _record._enter(self.name, None, self._t0)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) * 1e-9
        if self._rec is not None:
            self._rec._exit(self._i, t1)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _timed_open.pop()
        _setup[_timed_open[0] if _timed_open else self.name].append(
            (self.name, self.seconds))
        return None


def setup_seconds(top: str = "bdf.build") -> Dict[str, float]:
    """The seconds of each phase of the newest set-up that a ``timed(top)``
    opened outermost (``top`` itself among them), summed by name; empty
    where none has ended in this process."""
    out: Dict[str, float] = {}
    for name, secs in _setup.get(top, ()):
        out[name] = out.get(name, 0.0) + secs
    return out


def counter(obj, *attrs: str) -> None:
    """Register the integer attributes ``attrs`` of ``obj`` (a kernel
    wrapper's ``launches``, a plain version's ``calls``) as the counters
    ``<obj.__name__>.<attr>``."""
    for a in attrs:
        _counters[f"{obj.__name__}.{a}"] = (obj, a)


def counts() -> Dict[str, int]:
    """Every registered counter's value now."""
    return {k: getattr(o, a) for k, (o, a) in _counters.items()}


def advance(change: Dict[str, int]) -> None:
    """Add ``change`` ({counter: n}) to the registered counters: a phase
    replayed from a CUDA graph (``utils/graphs.py``) runs no Python, so
    its replay advances them by what its capture counted."""
    for k, n in change.items():
        o, a = _counters[k]
        setattr(o, a, getattr(o, a) + n)


@contextlib.contextmanager
def recording():
    """Record every span entered inside, in memory: yields the ``Record``,
    whose ``counters`` are filled when the stretch ends."""
    global _record
    if _record is not None:
        raise RuntimeError("a recording is already open")
    rec = Record()
    before = counts()
    _record = rec
    try:
        yield rec
    finally:
        _record = None
        after = counts()
        rec.counters = {k: v - before.get(k, 0) for k, v in after.items()}
        for name, (n, _) in rec.totals().items():
            rec.counters[name] = n
