"""Spans of the align pipeline, kept in memory on `time.perf_counter_ns`.

A span is (name, batch id, thread id, start ns, end ns, thread CPU ns).
The recorder is off until `start()`; `stop()` returns what it recorded and
switches it off. While off, `span()` hands back one shared null context and
reads no clock. Sites that also feed a `stage_times` counter time
themselves with a `Timer`: its one pair of clock readings is both the
counter's seconds and, while the recorder is on, the span. While on, a
`gc.callbacks` entry records each collection as a `gc` span.

The benchmark's traced run and the CLI's `--profiling` switch it on. The
benchmark ties `perf_counter_ns` to the profiler's timeline with one marker
annotation, so the spans land on the device trace's clock.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import List, Optional, Tuple

Span = Tuple[str, Optional[int], int, int, int, int]

NULL = contextlib.nullcontext()
_spans: Optional[List[Span]] = None
_gc_start = [0, 0]  # collections run one at a time, under the GIL


def on() -> bool:
    return _spans is not None


def start() -> None:
    """Switch the recorder on, with an empty list of spans."""
    global _spans
    if _spans is None:
        gc.callbacks.append(_gc)
    _spans = []


def stop() -> List[Span]:
    """Switch the recorder off; returns its spans in the order they ended."""
    global _spans
    out, _spans = _spans or [], None
    if _gc in gc.callbacks:
        gc.callbacks.remove(_gc)
    return out


def _gc(phase, _info) -> None:
    if phase == "start":
        _gc_start[:] = (time.perf_counter_ns(), time.thread_time_ns())
        return
    t1, c1 = time.perf_counter_ns(), time.thread_time_ns()
    spans = _spans
    if spans is not None and _gc_start[0]:
        spans.append(("gc", None, threading.get_ident(), _gc_start[0], t1,
                      c1 - _gc_start[1]))


class Timer:
    """Times from construction to `stop()` (or the end of a `with` block).
    `s` is then its seconds; `cpu_s` the thread's CPU seconds when `cpu`
    is set or the recorder is on, else 0. Recorded as a span while the
    recorder is on."""

    __slots__ = ("name", "batch", "t0", "c0", "t1", "s", "cpu_s")

    def __init__(self, name: str, batch: Optional[int] = None, cpu: bool = False):
        self.name = name
        self.batch = batch
        self.c0 = time.thread_time_ns() if cpu or _spans is not None else None
        self.t0 = time.perf_counter_ns()

    def stop(self) -> "Timer":
        self.t1 = time.perf_counter_ns()
        self.s = (self.t1 - self.t0) / 1e9
        cpu = time.thread_time_ns() - self.c0 if self.c0 is not None else 0
        self.cpu_s = cpu / 1e9
        spans = _spans
        if spans is not None:
            spans.append((self.name, self.batch, threading.get_ident(), self.t0,
                          self.t1, cpu))
        return self

    def __enter__(self) -> "Timer":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def span(name: str, batch: Optional[int] = None):
    """A `with` block recorded as a span while the recorder is on."""
    return NULL if _spans is None else Timer(name, batch)
