"""The traced window: ``torch.profiler`` over a stretch of the same traffic,
reduced to what the per-layer metrics and the breakdown read.

Device operations are the trace's kernels, copies and sets on the device.
The window is the harness's ``portbench.window`` range on the host's
timeline, which the profiler shares with the device's. Busy time is the
union of device operations inside it. Each idle gap is shared out among
the harness's host phases (``portbench.call``, ``.copy_out``, ``.wait``) by
how much of it each covers; what none covers is the ``host loop``.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without namespaces, template arguments or
    parameters (``deepsets_kernel``); other operations as they are."""
    n = name.replace("(anonymous namespace)::", "")
    m = re.match(r"[\w:]+", n)
    if m and m.end() < len(n) and n[m.end()] in "(<":
        return m.group(0).rsplit("::", 1)[-1]
    return name.strip()


def _is_device_op(e) -> bool:
    """A kernel, copy or set on the device; not the profiler's mirror of a
    host range on the device's timeline. (Older torch events carry no
    ``activity_type``: there the user-annotation flag tells them apart.)"""
    if e.device_type().name != "CUDA" or e.is_user_annotation():
        return False
    kind = getattr(e, "activity_type", None)
    return kind is None or kind() in DEVICE_ACTIVITIES


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def reduce(events) -> dict:
    """busy_s, window_s, kernel totals by short name, and the breakdown."""
    window = [e for e in events if e.name() == WINDOW
              and e.device_type().name == "CPU"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} windows")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    ops = []
    for e in events:
        if _is_device_op(e):
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t > s:
                ops.append((s, t, short_name(e.name())))
    busy = _union([(s, t) for s, t, _ in ops])
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, t, name in ops:
        by_name[name][0] += (t - s) * 1e-9
        by_name[name][1] += 1
    # The host's phases follow one another, so sorted by start they are
    # sorted by end too, and a gap's candidates are found by bisection.
    phases = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                    if e.device_type().name == "CPU" and e.name() != WINDOW
                    and e.name().startswith("portbench."))
    starts = [p[0] for p in phases]
    ends = [p[1] for p in phases]
    gaps = defaultdict(float)
    edges = [w0] + [x for span in busy for x in span] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        covered = 0
        for p0, p1, name in phases[bisect.bisect_right(ends, g0):
                                   bisect.bisect_left(starts, g1)]:
            o = _overlap(g0, g1, p0, p1)
            gaps[name] += o * 1e-9
            covered += o
        if g1 - g0 > covered:
            gaps["host loop"] += (g1 - g0 - covered) * 1e-9
    busy_s = sum(t - s for s, t in busy) * 1e-9
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-9,
        "kernels": {k: (v[0], v[1]) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": sorted(([k, v[0]] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:TOP],
        },
    }


def traced(fn):
    """Runs ``fn(label)`` under the profiler inside the window's range and
    returns the reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn(record_function)
    return reduce(prof.profiler.kineto_results.events())


def idle_share(trace) -> "float | None":
    """100 · (1 - busy / window) of a reduced trace; None without one."""
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
