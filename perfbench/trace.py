"""The traced run's device trace: ``torch.profiler`` over the window, reduced
in memory to what the per-layer readers and the breakdown need.

The harness opens ranges named ``perfbench/<entry>`` (``record_function``)
around the program's entry points. A device operation belongs to the
innermost range that was open on the host when it was launched: its launch
call (the CUDA runtime or driver event with the operation's correlation id)
lies inside the range. So a kernel is attributed by the entry point that
launched it, whatever its own name.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "perfbench/"
WINDOW = PREFIX + "window"


def patched(obj, name: str, wrapper_of):
    """Context: ``obj.name`` replaced by ``wrapper_of(original)``."""

    @contextlib.contextmanager
    def cm():
        orig = getattr(obj, name)
        setattr(obj, name, wrapper_of(orig))
        try:
            yield
        finally:
            setattr(obj, name, orig)

    return cm()


def ranged(label: str):
    """A wrapper factory that runs the wrapped call inside the range ``label``."""

    def wrap(fn):
        def inner(*a, **kw):
            with torch.profiler.record_function(PREFIX + label):
                return fn(*a, **kw)

        return inner

    return wrap


class Trace:
    """Device operations of the traced window and the harness's host ranges."""

    def __init__(self, ops, ranges, window: Tuple[int, int], wall_s: float):
        self.ops = ops  # [(start_ns, end_ns, name, range label or None)]
        self.ranges = ranges  # label -> [(start_ns, end_ns)] host intervals
        self.window = window
        self.window_s = wall_s
        self.busy_s = _union_s(self.ops, *window)

    def device_s(self, label: str) -> Optional[float]:
        """Device seconds of the operations launched under range ``label``
        (None when none were)."""
        tot = sum(e - s for s, e, _, lab in self.ops if lab == label)
        return tot / 1e9 if tot > 0 else None

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = {}
        for s, e, name, _ in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
        dev = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = {}
        for gs, ge in _gaps(self.ops, *self.window):
            label = _innermost(self.ranges, (gs + ge) // 2) or "host"
            gaps[label] = gaps.get(label, 0.0) + (ge - gs) / 1e9
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in dev],
                "idle_gaps": [[n, v] for n, v in idle]}


def _merged(ops, lo: int, hi: int) -> List[Tuple[int, int]]:
    iv = sorted((max(s, lo), min(e, hi)) for s, e, _, _ in ops if e > lo and s < hi)
    out: List[Tuple[int, int]] = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union_s(ops, lo: int, hi: int) -> float:
    return sum(e - s for s, e in _merged(ops, lo, hi)) / 1e9


def _gaps(ops, lo: int, hi: int) -> List[Tuple[int, int]]:
    out, t = [], lo
    for s, e in _merged(ops, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _innermost(ranges, t: int) -> Optional[str]:
    best, width = None, None
    for label, ivs in ranges.items():
        if label == WINDOW[len(PREFIX):]:
            continue
        i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
        for s, e in ivs[max(i - 4, 0): i + 1]:
            if s <= t < e and (width is None or e - s < width):
                best, width = label, e - s
    return best


def reduce(prof, wall_s: float) -> Trace:
    from torch.autograd import DeviceType

    dev, host_ranges, gpu_ranges, launch = [], {}, {}, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(PREFIX):  # the profiler's device image of a range
                gpu_ranges.setdefault(name[len(PREFIX):], []).append((s, e))
            else:
                dev.append((s, e, name, ev.correlation_id()))
        elif name.startswith(PREFIX):
            host_ranges.setdefault(name[len(PREFIX):], []).append((s, e))
        elif name.startswith("cu") and ev.correlation_id():
            launch[ev.correlation_id()] = s
    for ivs in host_ranges.values():
        ivs.sort()
    win = host_ranges.get(WINDOW[len(PREFIX):], [])
    if not win or not dev:
        raise RuntimeError("the profiler recorded no device activity in the window")
    window = (win[0][0], win[0][1])
    ops = []
    for s, e, name, corr in dev:
        t = launch.get(corr)
        label = _innermost(host_ranges, t) if t is not None else _within(gpu_ranges, s, e)
        ops.append((s, e, name, label))
    return Trace(ops, host_ranges, window, wall_s)


def _within(gpu_ranges, s: int, e: int) -> Optional[str]:
    best, width = None, None
    for label, ivs in gpu_ranges.items():
        if label == WINDOW[len(PREFIX):]:
            continue
        for a, b in ivs:
            if a <= s and e <= b and (width is None or b - a < width):
                best, width = label, b - a
    return best


@contextlib.contextmanager
def traced(out: dict):
    """Profile the block as the traced window; ``out["trace"]`` is its Trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["trace"] = reduce(prof, wall)
