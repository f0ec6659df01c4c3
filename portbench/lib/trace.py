"""The traced run's device timeline, from ``torch.profiler``.

Every device operation (kernel, copy, set) is an interval on the
profiler's clock; the window is the harness's ``pb.window`` range on the
same clock, and the harness's own ranges (``pb.<layer>``) say what the
host was doing.  From them: the device's busy seconds (the union of the
intervals inside the window), the time by operation name, and the busy
and the idle time split by the innermost harness range open at each
instant.
"""
from __future__ import annotations

import collections
import dataclasses

from torch.autograd import DeviceType

WINDOW = "pb.window"
PREFIX = "pb."


@dataclasses.dataclass
class Timeline:
    """What a traced window read: seconds throughout."""
    window_s: float
    busy_s: float
    by_op: dict            # device operation name -> seconds
    idle_by_host: dict     # harness range (or "none") -> idle seconds
    busy_by_host: dict     # harness range (or "none") -> busy seconds


def read(events) -> Timeline | None:
    """A :class:`Timeline` from kineto events (``prof.profiler.
    kineto_results.events()``); None when no device operation ran in
    the window (a run without a card, or a profiler that saw none).

    A range opened with ``record_function`` shows on the host's timeline
    and again on the device's; it is not device work.  A traced window
    holds millions of events, so each costs as few calls as it can."""
    cpu = DeviceType.CPU
    window, ranges, dev = None, [], []
    for ev in events:
        if ev.device_type() == cpu:
            if ev.is_user_annotation():
                name = ev.name()
                if name.startswith(PREFIX):
                    lo = ev.start_ns()
                    span = (lo, lo + ev.duration_ns())
                    if name == WINDOW:
                        window = span
                    else:
                        ranges.append(span + (name[len(PREFIX):],))
        elif not ev.is_user_annotation():
            lo = ev.start_ns()
            dev.append((lo, lo + ev.duration_ns(), ev.name()))
    if window is None or not dev:
        return None
    return timeline(window, dev, ranges)


def timeline(window, dev, ranges) -> Timeline | None:
    """:class:`Timeline` of device intervals ``dev`` ((start, end, name)
    in ns) and host ranges ``ranges`` ((start, end, label)) inside
    ``window`` (start, end)."""
    w0, w1 = window
    by_op = collections.Counter()
    spans = []
    for lo, hi, name in dev:
        lo, hi = max(lo, w0), min(hi, w1)
        if hi > lo:
            spans.append((lo, hi))
            by_op[name] += (hi - lo) * 1e-9
    if not spans:
        return None
    spans.sort()
    busy = 0
    gaps, merged = [], []
    cur_lo, cur_hi = spans[0]
    if cur_lo > w0:
        gaps.append((w0, cur_lo))
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            merged.append((cur_lo, cur_hi))
            gaps.append((cur_hi, lo))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    merged.append((cur_lo, cur_hi))
    if cur_hi < w1:
        gaps.append((cur_hi, w1))
    return Timeline(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                    by_op=dict(by_op),
                    idle_by_host=_label(gaps, ranges),
                    busy_by_host=_label(merged, ranges))


def _label(gaps, ranges) -> dict:
    """Seconds of the sorted, disjoint intervals ``gaps`` split by what
    the host was doing: each instant goes to the innermost (shortest)
    host range open then, or to "none"."""
    out = collections.Counter()
    if not gaps:
        return {}
    lo, hi = gaps[0][0], gaps[-1][1]
    points = sorted({lo, hi} | {t for r in ranges for t in r[:2]
                                if lo < t < hi})
    segs = []                                  # (start, end, label)
    for a, b in zip(points[:-1], points[1:]):
        mid, label, best = (a + b) / 2, "none", None
        for r0, r1, name in ranges:
            if r0 <= mid < r1 and (best is None or r1 - r0 < best):
                label, best = name, r1 - r0
        segs.append((a, b, label))
    k = 0
    for g0, g1 in gaps:
        while segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            a, b, label = segs[j]
            out[label] += (min(b, g1) - max(a, g0)) * 1e-9
            j += 1
    return dict(out)


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest (name, seconds) pairs of ``d``."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
