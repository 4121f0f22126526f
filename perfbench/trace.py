"""The traced run's device timeline, from ``torch.profiler``: busy seconds
(the union of the device's operation intervals), kernel seconds, the
operations that took most time, and the idle gaps by what the host was doing
(the innermost benchmark span or program phase around each gap).

Spans are ``torch.profiler.record_function`` ranges named ``phase:<name>``
(the program's phases, seen through the benchmark's timer) or
``bench:<name>`` (the benchmark's own), so they share the kernels' clock.
"""

from __future__ import annotations

import bisect
import collections


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _label(spans, t: float) -> str:
    """The shortest span around time ``t``."""
    best, best_len = "no span", None
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    for s, e, name in spans[max(0, i - 4096):i]:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def reduce(events) -> dict:
    """``events``: (start_us, end_us, name, on_device) tuples.  Returns
    busy_s, kernel_s, the traced window (the ``bench:window`` span) and the
    breakdown lists."""
    dev = [(s, e, n) for s, e, n, d in events if d]
    spans = sorted((s, e, n.split(":", 1)[1]) for s, e, n, d in events
                   if not d and n.startswith(("phase:", "bench:")))
    win = [(s, e) for s, e, n in spans if n == "window"]
    lo, hi = (win[0] if win else
              (min((s for s, _, _ in dev), default=0.0),
               max((e for _, e, _ in dev), default=0.0)))
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
    busy = union_length([(s, e) for s, e, _ in inside])
    kern = [(s, e, n) for s, e, n in inside
            if not n.startswith(("Memcpy", "Memset"))]
    by_op = collections.Counter()
    for s, e, n in inside:
        by_op[n] += (e - s) / 1e6
    idle = collections.Counter()
    for s, e in gaps([(s, e) for s, e, _ in inside], lo, hi):
        idle[_label(spans, (s + e) / 2)] += (e - s) / 1e6
    return dict(busy_s=busy / 1e6, window_s=(hi - lo) / 1e6,
                kernel_s=sum(e - s for s, e, _ in kern) / 1e6,
                device_ops=[[n, v] for n, v in by_op.most_common(10)],
                idle_gaps=[[n, v] for n, v in idle.most_common(10)])


def events_of(prof) -> list:
    """(start_us, end_us, name, on_device) of a finished profile.  The raw
    Kineto events, which need no event tree; the device's copies of the
    ``record_function`` ranges are annotations, not work, and are left
    out."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    out = []
    for ev in res.events():
        name = ev.name()
        on_dev = ev.device_type() == DeviceType.CUDA
        if on_dev and (ev.is_user_annotation()
                       or name.startswith(("phase:", "bench:"))):
            continue
        out.append(((ev.start_ns() - t0) / 1e3, (ev.end_ns() - t0) / 1e3,
                    name, on_dev))
    return out
