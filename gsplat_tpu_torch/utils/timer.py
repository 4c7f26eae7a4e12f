"""The port's tracing: spans at the program's stages, and stage timing
around device work (``gsplat_tpu/utils/timer.py``).

``with span(name, id=None):`` marks one stage.  Off, the default, it costs
one check of a module flag and returns a shared no-op object: nothing is
recorded and ``torch.profiler`` is not reached.  After ``enable(True)``
each span keeps a :class:`SpanRecord` in memory (its name, its start and
end on the host clock, ``time.perf_counter_ns``, the index of the span
open around it and an ``id``: a span given none takes its parent's, so
the spans of one iteration or one request share its identifier) and opens
``torch.profiler.record_function(name)`` for its length, so a profiler
that records the host shows it as a host event on the profiler's clock.
``take()`` returns the closed records and drops them; nothing is written
out.  The stack of open spans is the process's: spans are opened by one
thread.

The program's spans (a ``sync.*`` span wraps a place where the host waits
for the card on purpose; their count is the program's host-sync counter):

- trainer: ``trainer.window`` (``Trainer.train``: a window's steps, its
  host events and its log; id the window's last iteration),
  ``trainer.step`` (``Trainer._step``; id the iteration),
  ``trainer.densify`` (``Trainer._densify``), ``trainer.opacity_reset``,
  ``sync.log`` (the window log's reads of the metrics);
- step: ``step.project``, ``step.pack`` with ``sync.pack`` inside it (the
  pack's read of its pair count), ``step.composite`` (compositing, clamp
  and crop), ``step.loss``, ``step.backward``, ``step.adam``;
- serve: ``serve.request`` (``viewer.render_offscreen``; id a request
  counter) and ``serve.to_host`` (the frame's copy to the host).

:class:`StageTimer` brackets a stage and records its interval under a name
in a class-level recorder: with CUDA events on a CUDA device (the time the
stream spends between the two events; reading it synchronises with the
second event), with ``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import itertools
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(slots=True)
class SpanRecord:
    """One span: ``index`` numbers the process's spans from 0 in the order
    they open; ``parent`` is the index of the span open around it (None at
    the top); times in ns of ``time.perf_counter_ns``."""
    index: int
    name: str
    id: object
    parent: int | None
    start_ns: int
    end_ns: int | None = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


_on = False
_open: list = []       # the open spans' records, innermost last
_records: list = []    # every record not yet taken, in the order opened
_index = itertools.count()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "record", "range")

    def __init__(self, name: str, id):
        self.name, self.id = name, id

    def __enter__(self):
        parent = _open[-1] if _open else None
        ident = self.id if self.id is not None or parent is None \
            else parent.id
        self.record = SpanRecord(next(_index), self.name, ident,
                                 parent.index if parent else None,
                                 time.perf_counter_ns())
        _records.append(self.record)
        _open.append(self.record)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.record.end_ns = time.perf_counter_ns()
        _open.pop()
        return False


def span(name: str, id=None):
    """A context manager around one stage of the program: the shared no-op
    while spans are off, else a recorded span (module docstring)."""
    if not _on:
        return _OFF
    return _Span(name, id)


def enable(on: bool = True):
    """Turn the spans on or off; records already kept stay until taken."""
    global _on
    _on = bool(on)


def take() -> list:
    """The closed spans' records, in the order they opened, dropped from
    memory; spans still open are kept until they close and are taken."""
    done = [r for r in _records if r.end_ns is not None]
    _records[:] = [r for r in _records if r.end_ns is None]
    return done


def summary(records) -> dict:
    """{name: {"n", "mean_ms", "self_ms"}} of ``records``: the count, the
    mean duration and the mean self time (the duration less the durations
    of the spans directly inside it)."""
    children = defaultdict(int)
    for r in records:
        if r.parent is not None:
            children[r.parent] += r.duration_ns
    by_name = defaultdict(lambda: [0, 0, 0])
    for r in records:
        s = by_name[r.name]
        s[0] += 1
        s[1] += r.duration_ns
        s[2] += r.duration_ns - children[r.index]
    return {k: {"n": n, "mean_ms": tot / n / 1e6, "self_ms": own / n / 1e6}
            for k, (n, tot, own) in by_name.items()}


class StageTimer:
    recorder = defaultdict(list)

    def __init__(self, des: str = "", debug: bool = True, device=None):
        self.des = des
        self.debug = debug
        self.cuda = torch.device(device).type == "cuda" \
            if device is not None else False

    def __enter__(self):
        if self.debug:
            if self.cuda:
                self._events = [torch.cuda.Event(enable_timing=True)
                                for _ in range(2)]
                self._events[0].record()
            else:
                self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.debug:
            return
        if self.cuda:
            self._events[1].record()
            self._events[1].synchronize()
            self.interval = self._events[0].elapsed_time(self._events[1]) \
                / 1e3
        else:
            self.interval = time.perf_counter() - self.start
        StageTimer.recorder[self.des].append(self.interval)

    @classmethod
    def means(cls) -> dict:
        """Mean seconds per stage."""
        return {k: float(np.mean(v)) for k, v in cls.recorder.items()}

    @classmethod
    def reset(cls):
        cls.recorder = defaultdict(list)
