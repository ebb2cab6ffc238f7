"""The program's own spans in a traced window, as the per-layer readers
take them: the intervals of a named span that lie wholly inside the
window, and the card's busy time inside each interval.

The program records a span as a plain host range (``cpu_op``) on
kineto's clock, which kineto aligns with the device's kernels, so its
spans sit in ``Trace.host`` beside the host's other events; a program
without a span of that name gives none, and the readers then read
nothing. The program opens a span only while a profiler records, so a
span open when the profiler started is not in the trace; one open when
it stopped is either missing or closed at the stop, after every other
event's start (torch versions differ), and is left out here.
"""
from __future__ import annotations

import bisect


def whole(trace, name: str) -> list:
    """(start ns, end ns) of each span ``name`` recorded whole, in order:
    some host event of the window starts before it starts and some starts
    after it ends."""
    starts = [s for _, s, _ in trace.host]
    if not starts:
        return []
    first, last = min(starts), max(starts)
    return sorted((s, e) for n, s, e in trace.host
                  if n == name and first < s and e < last)


def _merged(device) -> list:
    out = []
    for s, e in sorted((s, e) for _, s, e in device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(trace, intervals) -> list:
    """For each (start ns, end ns) of ``intervals``, the seconds inside it
    in which the card ran a kernel or a copy (the union of
    ``trace.device``'s intervals, clipped to it)."""
    merged = _merged(trace.device)
    ends = [e for _, e in merged]
    out = []
    for lo, hi in intervals:
        i, ns = bisect.bisect_right(ends, lo), 0
        while i < len(merged) and merged[i][0] < hi:
            ns += min(merged[i][1], hi) - max(merged[i][0], lo)
            i += 1
        out.append(ns / 1e9)
    return out


def mean_busy_ms(trace, name: str):
    """The card's busy ms inside each whole span ``name``, the mean over
    those spans; None where the trace has no device event or no such
    span."""
    if trace is None or not trace.device:
        return None
    got = whole(trace, name)
    if not got:
        return None
    return 1e3 * sum(busy_s(trace, got)) / len(got)
