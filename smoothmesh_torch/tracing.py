"""Spans and counters of one smoother (:attr:`Smoother.trace`).

A :class:`Trace` keeps, for each span name, its count, total and
longest seconds and the span open around its first instance (its
parent), and integer counters.  It aggregates and keeps no list, so a
long job's trace does not grow.  The smoother records:

- set-up spans, always: ``setup.reorder``, ``setup.topology``,
  ``setup.stats``, ``setup.upload``, ``setup.layer_maps`` (the
  ``Smoother``), ``setup.boundary.classify`` and
  ``setup.boundary.tables`` (``enable_boundary_smoothing``),
  ``setup.capture`` (a batch built, on the card warmed up and captured;
  also inside ``steps``, apart from its batch's wall); the
  decompositions' ``setup.shard_build`` (and in it ``setup.compiles``),
  ``setup.union`` and ``setup.upload``;
- batch spans, always: ``batch.reset``, ``batch.replay``,
  ``batch.read`` and ``batch.commit``, the parts of one batch of
  ``Smoother.steps`` (``StepResult.wall_ms`` is reset to read over the
  iterations that ran);
- the counter ``host_reads``: every read of the device by the iteration
  loop (a batch's record, an iteration run one a dispatch, the
  face-angle fixed point's reads);
- the iteration's stages timed on the device, when
  ``Smoother.time_stages(True)`` asks for them: ``iter.geometry``,
  ``iter.normals``, ``iter.predictor``, ``iter.layer_blend``,
  ``iter.boundary_projection``, ``iter.freeze``, ``iter.face_angle``
  and ``iter.commit``, one sample a batch (its last iteration).

No span synchronizes the device, so a span around work that launches
on the card ends when the launches are issued.  While a
``torch.profiler`` records this thread, each span also opens
``record_function("smoothmesh::" + name)``, so it lands in the
profiler's trace beside the device's operations and on its clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

#: the prefix of the spans' ranges in a profiler's trace
PREFIX = "smoothmesh::"


@dataclasses.dataclass
class Span:
    """One span name's aggregate."""

    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    #: the span open around this one's first instance, if any
    parent: Optional[str] = None


class Timed:
    """A span being timed (:meth:`Trace.span`); ``start_ns`` and
    ``end_ns`` are ``time.perf_counter_ns`` readings."""

    __slots__ = ("trace", "name", "parent", "start_ns", "end_ns", "_range")

    def __init__(self, trace: "Trace", name: str):
        self.trace = trace
        self.name = name

    def __enter__(self) -> "Timed":
        opened = self.trace._open
        self.parent = opened[-1] if opened else None
        opened.append(self.name)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self.trace._open.pop()
        self.trace.add(self.name, (self.end_ns - self.start_ns) * 1e-9,
                       self.parent)


class Trace:
    """Spans (:class:`Span` by name) and counters of one smoother, used
    by one thread at a time."""

    def __init__(self):
        self.spans: dict = {}
        self.counters: dict = {}
        self._open: list = []

    def span(self, name: str) -> Timed:
        """A context manager that times its block as ``name``."""
        return Timed(self, name)

    def add(self, name: str, seconds: float, parent: Optional[str] = None,
            count: int = 1) -> None:
        """Add ``count`` instances of ``name`` that took ``seconds``."""
        s = self.spans.get(name)
        if s is None:
            s = self.spans[name] = Span(parent=parent)
        s.count += count
        s.total_s += seconds
        s.max_s = max(s.max_s, seconds / count)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        self.counters[name] = self.counters.get(name, 0) + n

    def total(self, name: str) -> float:
        """The total seconds of ``name`` (0.0 if it never ran)."""
        s = self.spans.get(name)
        return s.total_s if s is not None else 0.0

    def merge(self, other: "Trace", parent: Optional[str] = None) -> None:
        """Add ``other``'s spans and counters; its top-level spans get
        ``parent``."""
        for name, s in other.spans.items():
            self.add(name, s.total_s, s.parent or parent, s.count)
            self.spans[name].max_s = max(self.spans[name].max_s, s.max_s)
        for name, n in other.counters.items():
            self.count(name, n)


class StageClock:
    """The boundaries of an iteration's stages: :meth:`start` at its
    beginning, then ``mark(name)`` where the stage ``name`` ends (a name
    may end more than one interval; their times add).  On the card each
    boundary records a timing event made with ``external=True``, so that
    a CUDA graph capture records it as an event node and every replay
    rewrites it; on the CPU it reads the host's clock.  The marks of
    every call must come in one order."""

    def __init__(self, device: torch.device):
        self.on_card = torch.device(device).type == "cuda"
        self.names: list = []
        self.stamps: list = []
        self.i = 0

    def start(self) -> None:
        self.i = 0
        self.mark(None)

    def mark(self, name: Optional[str]) -> None:
        i = self.i
        if i == len(self.stamps):
            self.names.append(name)
            self.stamps.append(torch.cuda.Event(enable_timing=True,
                                                external=True)
                               if self.on_card else 0)
        elif self.names[i] != name:
            raise RuntimeError(f"stage {name!r} where the clock's marks "
                               f"have {self.names[i]!r}")
        if self.on_card:
            self.stamps[i].record()
        else:
            self.stamps[i] = time.perf_counter_ns()
        self.i = i + 1

    def read(self) -> dict:
        """Each stage's seconds in the last call; on the card, once the
        work that recorded the events is done (after a host read)."""
        out = {}
        for i in range(1, self.i):
            a, b = self.stamps[i - 1], self.stamps[i]
            s = (a.elapsed_time(b) * 1e-3 if self.on_card
                 else (b - a) * 1e-9)
            out[self.names[i]] = out.get(self.names[i], 0.0) + s
        return out

    def record(self, trace: Trace) -> None:
        """Add :meth:`read`'s stage times to ``trace`` as spans."""
        for name, s in self.read().items():
            trace.add(name, s)


@contextlib.contextmanager
def profiled(profile_dir: Optional[str], device: torch.device):
    """A ``torch.profiler`` trace of the block (host activity of this
    thread and, on the card, CUDA activity) written into
    ``profile_dir`` as a Chrome trace; no profiler where it is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield
