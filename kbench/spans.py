"""Spans and counters of the traced run, recorded from the benchmark's
side around the program's calls into its layers.

A per-layer metric file declares the spans it reads in a list `SPANS`
of `Wrap`s: the attribute through which the program calls a function
(or takes a class), the span's name, and how to wrap it.  The helpers
below make the common kinds (`call`, `each_item`, `open_after`,
`close_after`); a metric file may give a `Wrap` a maker of its own.  The
harness installs the union of the declarations of a cell's per-layer
metrics, in the traced run only, and `remove` puts the attributes back.
So a metric over a layer that no file wraps yet is a new file alone.

A span is a `torch.profiler.record_function` range `kbench.<span>`,
which the trace keeps (`Trace.device_s_in(span)` sums the device time
launched inside it), its host seconds (`Spans.host_s`) and, for `call`
with `sizes`, each call's sizes (`Spans.calls`), the device scalars
among them turned into integers once a job has synchronised.  Each
wrapper of a function carries the function's attributes (the kernels'
launch counters count on in it).
"""

import functools
import importlib
import inspect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable

import torch
from torch.profiler import record_function


@dataclass(frozen=True)
class Wrap:
    """Replace `module.attr` by `make(spans, original)` for span `span`."""
    module: str
    attr: str
    span: str
    make: Callable


def _target(target):
    module, attr = target.split(":")
    return module, attr


def call(target, span, sizes=None):
    """A span around each call of the function at "module:attr";
    sizes(args, out) -> {name: int or device scalar} records each call's
    sizes, `args` being its arguments by name, defaults filled in."""
    def make(spans, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with spans.span(span):
                out = fn(*args, **kw)
            if sizes is not None:
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                spans.record(span, sizes(bound.arguments, out))
            return out
        return wrapped
    return Wrap(*_target(target), span, make)


def each_item(target, span):
    """A span around the taking of each item from the iterators of the
    class at "module:attr" (a consumer's wait for its producer)."""
    def make(spans, cls):
        class Timed(cls):
            def __iter__(self):
                it = super().__iter__()
                while True:
                    with spans.span(span):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    yield item
        Timed.__name__ = Timed.__qualname__ = cls.__name__
        return Timed
    return Wrap(*_target(target), span, make)


def open_after(target, span):
    """Open `span` when the function at "module:attr" returns; one still
    open from its last return (no `close_after` came) ends as the call
    starts."""
    def make(spans, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            spans.close(span)
            out = fn(*args, **kw)
            spans.open(span)
            return out
        return wrapped
    return Wrap(*_target(target), span, make)


def close_after(target, span):
    """Close `span`, if open, when the function at "module:attr" returns."""
    def make(spans, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            try:
                return fn(*args, **kw)
            finally:
                spans.close(span)
        return wrapped
    return Wrap(*_target(target), span, make)


class Spans:
    def __init__(self, wraps=()):
        # one of each (module, attribute, span), in the order declared
        self.wraps = list({(w.module, w.attr, w.span): w
                           for w in wraps}.values())
        self.host_s = defaultdict(float)
        self.calls = defaultdict(list)
        self._undo = []
        self._open = {}
        self._unsettled = []

    def install(self):
        for w in self.wraps:
            mod = importlib.import_module(w.module)
            old = getattr(mod, w.attr)
            self._undo.append((mod, w.attr, old))
            setattr(mod, w.attr, w.make(self, old))
        return self

    def remove(self):
        while self._undo:
            mod, attr, old = self._undo.pop()
            setattr(mod, attr, old)

    def span(self, name):
        return _Span(self, name)

    def open(self, name):
        self._open[name] = self.span(name).__enter__()

    def close(self, name):
        s = self._open.pop(name, None)
        if s is not None:
            s.__exit__(None, None, None)

    def record(self, name, sizes):
        """Record a call's sizes, some of them device scalars."""
        self.calls[name].append(sizes)
        self._unsettled.append(sizes)

    def settle(self):
        """Turn the recorded device scalars into integers (after a job
        has synchronised)."""
        for c in self._unsettled:
            for key, v in c.items():
                if isinstance(v, torch.Tensor):
                    c[key] = int(v)
        self._unsettled = []


class _Span:
    """A named range in the trace and its host seconds."""

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.rf = record_function(f"kbench.{self.name}")
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.host_s[self.name] += time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        return False
