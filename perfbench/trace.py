"""Device time from a ``torch.profiler`` trace of a run of calls.

:func:`profile_calls` runs calls under the profiler and reduces its events
to a :class:`Profile`: the union of kernel, copy and set intervals on the
card (busy), the host's wall time of the profiled calls (window), device
time by operation name, and the idle gaps between device intervals named
by the innermost host operation running at each gap's middle.
"""

from __future__ import annotations

import bisect
import time

import torch

__all__ = ["Profile", "profile_calls", "reduce_events", "split_events"]

CALL_LABEL = "perfbench.call"


class Profile:
    def __init__(self, busy_s, window_s, calls, device_ops, idle_gaps):
        self.busy_s = busy_s
        self.window_s = window_s
        self.calls = calls
        self.device_ops = device_ops  # [(name, seconds)], most first
        self.idle_gaps = idle_gaps  # [(host operation, seconds)], most first


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(device, host, window_s, calls, top=10):
    """``device``: ``(start_us, end_us, name)`` of each operation on the
    card; ``host``: ``(start_us, end_us, name)`` of each host operation.
    Returns a :class:`Profile`."""
    merged = _merge([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in merged) / 1e6
    per_op: dict[str, float] = {}
    for s, e, name in device:
        per_op[name] = per_op.get(name, 0.0) + (e - s) / 1e6
    host = sorted(host)
    starts = [h[0] for h in host]
    calls_ev = [h for h in host if h[2] == CALL_LABEL]
    lo = min((h[0] for h in calls_ev), default=merged[0][0] if merged else 0.0)
    hi = max((h[1] for h in calls_ev), default=merged[-1][1] if merged else 0.0)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps: dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "no host operation"
        j = bisect.bisect_right(starts, mid) - 1
        for _ in range(4096):
            if j < 0:
                break
            if host[j][1] >= mid:
                name = host[j][2]
                break
            j -= 1
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return Profile(busy_s, window_s, calls, ops, idle)


def profile_calls(fn, min_calls: int, seconds: float, sync=torch.cuda.synchronize):
    """Run ``fn(i)`` under the profiler, each call labelled, for at least
    ``min_calls`` calls and ``seconds`` of host time; end in ``sync``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        i = 0
        while i < min_calls or time.perf_counter() - t0 < seconds:
            with record_function(CALL_LABEL):
                fn(i)
            i += 1
        sync()
        window_s = time.perf_counter() - t0
    device, host = split_events(prof.events())
    return reduce_events(device, host, window_s, i)


def split_events(events):
    """``(device, host)`` lists of ``(start_us, end_us, name)`` from the
    profiler's events. A labelled region (``record_function``) is also
    projected onto the card's timeline as a user annotation: that is no
    operation on the card and stays out of the device list."""
    device, host = [], []
    for e in events:
        tr = e.time_range
        item = (float(tr.start), float(tr.end), e.name)
        if str(e.device_type).endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False) and e.name != CALL_LABEL:
                device.append(item)
        else:
            host.append(item)
    return device, host
