"""Names for the device's idle gaps, from the host spans that cover them.

A gap is labelled with the program span (groot_tpu_torch.obs) that covers
most of it, among the `gc` spans of any thread and the spans of the launch
thread, the one that runs `phase_a.submit`; the launch thread's parent span
`align.run` covers every gap of a pass and names none. Where no such span
covers a gap, the benchmark's own spans name it as before: the one that
covers most of it, a `pass.*` span only where nothing else does, and
`idle` where none does.

All times are microseconds on one clock (the profiler's).
`Profile.reduce` in `trace.py` labels its gaps with the benchmark's spans
alone; passing the program's spans here as well is left to the change that
edits the harness to record them.
"""

from __future__ import annotations

import collections
from typing import Iterable, List, Optional, Sequence, Tuple

LAUNCH = "phase_a.submit"
PARENT = "align.run"


def _most(a: float, b: float, spans: Iterable[Tuple[str, float, float]]) -> Optional[str]:
    over = collections.defaultdict(float)
    for n, sa, sb in spans:
        lo, hi = max(a, sa), min(b, sb)
        if hi > lo:
            over[n] += hi - lo
    return max(over, key=over.get) if over else None


def label(gaps: Sequence[Tuple[float, float]], host: Sequence[Tuple[str, float, float]],
          program: Sequence[tuple] = ()) -> List[list]:
    """[name, seconds] for each gap (a, b). `host`: the benchmark's spans
    (name, start, end); `program`: obs spans (name, batch, thread, start,
    end, ...)."""
    tid = next((s[2] for s in program if s[0] == LAUNCH), None)
    prog = [(s[0], s[3], s[4]) for s in program
            if s[0] == "gc" or (s[2] == tid and s[0] != PARENT)]
    inner = [s for s in host if not s[0].startswith("pass.")]
    out = []
    for a, b in gaps:
        name = _most(a, b, prog) or _most(a, b, inner) or _most(a, b, host) or "idle"
        out.append([name, (b - a) / 1e6])
    return out
