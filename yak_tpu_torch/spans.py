"""Named spans and counters of the program, on the profiler's clock.

`span(name, hook=None)` is a context manager around one phase of the
program's work as the host queues it (a fold's extract, sort, gate and
merge, the staging of a group of chunks, the wait for the reader, qv's
per-job work).  Spans are on while `enable()` holds or a
`torch.profiler` profile records on the calling thread (the benchmark's
traced run, YAK_TPU_PROFILE's trace, `utils.maybe_profile`); no other
setting turns them on.

Off, a span costs a flag test and the profiler's own one: it reads no
clock, enters no profiler range and records nothing.  On, it adds the
span's host seconds to its name's total and, while a profiler records,
enters a `torch.profiler.record_function` range "yak.<name>", so that
the range lies in the same trace as the device's operations, on the
profiler's clock, and each device gap can be put down to the program
range the host was in.  A range costs some 10-20 us of host time;
without a profiler there is no trace to hold it, and none is entered.

`hook`, where given, is the phase seam of the table, the steps and the
mesh functions: it is called, on or off, with the span's phase as the
span ends (`mark`, by default the last part of `name`: "fold.extract"
calls hook("extract")), and with `opens` as it begins where that is
given; an exit mark is not called when the body raises.

`count(name, n)` adds to a counter while spans are on.  The names are
listed in PERF.md §3 with the metric that reads each.
"""

import time
from collections import defaultdict

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_LEAF = object()        # mark: the last part of the span's name


class _Record:
    """What the spans recorded since the last reset."""

    def __init__(self):
        self.totals = defaultdict(lambda: [0, 0.0])  # name -> [calls, s]
        self.counters = defaultdict(float)


_on = False
_rec = _Record()


def enabled():
    """Whether spans record now: enable() or a profiler on this thread."""
    return _on or _profiler_enabled()


def enable(on=True):
    global _on
    _on = bool(on)


def reset():
    global _rec
    _rec = _Record()


def count(name, n=1):
    if enabled():
        _rec.counters[name] += n


def span(name, hook=None, *, opens=None, mark=_LEAF):
    """The span `name` as a context manager (module note); off and
    without a hook, one shared no-op."""
    traced = _profiler_enabled()
    if not (_on or traced) and hook is None:
        return _NOOP
    if mark is _LEAF:
        mark = name.rpartition(".")[2]
    if _on or traced:
        return _Span(name, hook, opens, mark, traced)
    return _Marks(hook, opens, mark)


def snapshot():
    """{"spans": {name: (calls, host s)}, "counters": {name: value}} of
    what was recorded since the last reset."""
    return {"spans": {k: tuple(v) for k, v in _rec.totals.items()},
            "counters": dict(_rec.counters)}


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()


class _Marks:
    """Off, with a hook: the phase marks alone."""

    __slots__ = ("hook", "opens", "mark")

    def __init__(self, hook, opens, mark):
        self.hook, self.opens, self.mark = hook, opens, mark

    def __enter__(self):
        if self.opens is not None:
            self.hook(self.opens)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None and self.mark is not None:
            self.hook(self.mark)
        return False


class _Span(_Marks):
    """On: the host seconds and, traced, the profiler range."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name, hook, opens, mark, traced):
        super().__init__(hook, opens, mark)
        self.name = name
        self.rf = record_function("yak." + name) if traced else None

    def __enter__(self):
        if self.hook is not None and self.opens is not None:
            self.hook(self.opens)
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(exc_type, *exc)
        tot = _rec.totals[self.name]
        tot[0] += 1
        tot[1] += t1 - self.t0
        if self.hook is not None and exc_type is None \
                and self.mark is not None:
            self.hook(self.mark)
        return False
