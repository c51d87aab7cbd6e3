"""Spans the benchmark records around the program's layers, and the
reduction of a torch.profiler trace of the window to device busy time,
kernel times and the breakdown.

Spans are host-clock intervals (`time.perf_counter_ns`) taken by wrappers
that the benchmark installs around the program's functions in the traced
run only, so the timed run carries none of them. A marker annotation at
the start of the profiling session ties the two clocks together.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Dict, List, Tuple

# torch.profiler can lose the first kernel records of a session after a long
# one; each session first spins this many sleep kernels, which take the loss
ABSORB = 32
ABSORB_KERNEL = "spin_kernel"
MARKER = "bench.marker"


class Spans:
    """Named host intervals from any thread, and wrappers that record them."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()
        self._undo = []

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def wrap(self, owner, attr: str, name: str, on_call=None) -> None:
        """Record every call of owner.attr as a span `name`; on_call(args,
        kwargs, result) sees each call's arguments. Undone by `restore`."""
        raw = owner.__dict__[attr]
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def run(*a, **kw):
            t0 = time.perf_counter_ns()
            try:
                out = fn(*a, **kw)
            finally:
                self.add(name, t0, time.perf_counter_ns())
            if on_call is not None:
                on_call(a, kw, out)
            return out

        setattr(owner, attr, run)
        self._undo.append((owner, attr, raw))

    def restore(self) -> None:
        for owner, attr, raw in reversed(self._undo):
            setattr(owner, attr, raw)
        self._undo.clear()

    def seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.items if n == name) / 1e9


def absorb() -> None:
    import torch

    for _ in range(ABSORB):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


class Profile:
    """torch.profiler over the window: CPU and CUDA activity, the absorbing
    sleep kernels first, then the clock marker."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        absorb()
        with record_function(MARKER):
            self.marker_ns = time.perf_counter_ns()
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def reduce(self, passes: List[Tuple[int, int]], spans: Spans, kernels: Dict[str, str]):
        """From the trace: busy seconds of the device inside the passes,
        the passes' seconds, {kernel: (launches, device seconds)} for
        kernels {name: device function name}, and the breakdown."""
        import torch

        events = self.prof.events()
        marker = [e for e in events if e.name == MARKER]
        if not marker:
            return None
        off_us = marker[0].time_range.start - self.marker_ns / 1e3
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and ABSORB_KERNEL not in e.name]
        win = [(a / 1e3 + off_us, b / 1e3 + off_us) for a, b in passes]
        ivs = sorted((e.time_range.start, e.time_range.end, e.name) for e in dev)
        busy_us = 0.0
        merged: List[List[float]] = []
        for a, b, _n in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        for wa, wb in win:
            for a, b in merged:
                lo, hi = max(a, wa), min(b, wb)
                if hi > lo:
                    busy_us += hi - lo
        window_s = sum(b - a for a, b in win) / 1e6
        per_op = collections.defaultdict(float)
        for a, b, n in ivs:
            if any(a < wb and b > wa for wa, wb in win):
                per_op[n] += (b - a) / 1e6
        kern = {}
        for name, func in kernels.items():
            hit = [(a, b) for a, b, n in ivs if func in n
                   and any(a < wb and b > wa for wa, wb in win)]
            kern[name] = (len(hit), sum(b - a for a, b in hit) / 1e6)
        gaps = []
        for wa, wb in win:
            inside = [(max(a, wa), min(b, wb)) for a, b in merged if b > wa and a < wb]
            edges = [wa] + [x for iv in inside for x in iv] + [wb]
            for i in range(0, len(edges), 2):
                if edges[i + 1] > edges[i]:
                    gaps.append((edges[i], edges[i + 1]))
        host = [(n, a / 1e3 + off_us, b / 1e3 + off_us) for n, a, b in spans.items]
        labelled = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            over = collections.defaultdict(float)
            for n, ha, hb in host:
                lo, hi = max(a, ha), min(b, hb)
                if hi > lo:
                    over[n] += hi - lo
            inner = {n: v for n, v in over.items() if not n.startswith("pass.")}
            pick = inner or over
            labelled.append([max(pick, key=pick.get) if pick else "idle", (b - a) / 1e6])
        return {
            "busy_s": busy_us / 1e6,
            "window_s": window_s,
            "kernels": kern,
            "breakdown": {
                "device_ops": sorted(([n, s] for n, s in per_op.items()),
                                     key=lambda x: -x[1])[:10],
                "idle_gaps": labelled,
            },
        }
