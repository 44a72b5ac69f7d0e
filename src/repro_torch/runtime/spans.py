"""Named ranges at the port's own step boundaries, seen by ``torch.profiler``.

    with span("tick.sample"):                                 # a range
        ...
    with span("epoch.sync", self.phase_seconds, "sync"):      # and a timer
        ...

A span is a profiler range named ``PREFIX + name``, opened only while a
torch profiler is recording on the calling thread. Otherwise it costs one
check, plus, with ``seconds``, the two clock reads of the host time it adds
to ``seconds[key]``. There is no switch: the spans appear under any
``torch.profiler.profile`` around the program and nowhere else.

The range is a function-scope one (``_RecordFunctionFast``, as compiled
graphs mark theirs), not a user-scope ``record_function``: on the card the
profiler draws a user-scope range a second time on the device's timeline
(a ``gpu_user_annotation`` event), and a trace reader that counts every
device event as work would count that image as the device being busy. A
span is a host event only; an operation belongs to the spans open on the
host when it was launched.

The MaxMem epoch's spans; a dotted name lies inside the span it extends,
``tick`` inside ``epoch``, and the ``tick.*`` stages cover every operation
``epoch_step`` launches:

    record                  CentralManager.record_access: the backlog fold
    epoch                   one run_epoch / run_epochs
      tick                  the policy.epoch_step call (feeds phase "tick")
        tick.sample         sampler, and the backlog reset
        tick.queue          in-flight mask and depth; enqueue, drain, flips
        tick.sums           per-(tenant, tier) sample sums
        tick.bins           counter fold and cooling
        tick.fmmr           FMMR update; reallocation and quotas
        tick.hist           candidate histogram, prefix sums, holdings
        tick.victims        victim masks and the plan
        tick.sentinel       invariant words
      epoch.sync            drained ids to the host (feeds phase "sync")
      dataplane             PagePool.execute (feeds phase "execute")
        dataplane.plan      the frame table's host loops
        dataplane.upload    plan arrays built and copied to the device
        dataplane.launch    the page_move call (feeds move_seconds)
      epoch.stats           queue counters, failed-move reverts, flags
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "maxmem."

_OFF = contextlib.nullcontext()


def _range(name: str) -> _RecordFunctionFast:
    return _RecordFunctionFast(PREFIX + name)


class _Span:
    __slots__ = ("name", "seconds", "key", "rf", "t0")

    def __init__(self, name: str, seconds: Optional[Dict[str, float]], key: Optional[str]):
        self.name, self.seconds, self.key = name, seconds, key

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = _range(self.name)
            self.rf.__enter__()
        if self.seconds is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.seconds is not None:
            self.seconds[self.key] += time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, seconds: Optional[Dict[str, float]] = None, key: Optional[str] = None):
    """Context: the range ``PREFIX + name`` while a profiler records; with
    ``seconds``, the block's host time added to ``seconds[key]``."""
    if seconds is not None:
        return _Span(name, seconds, key)
    return _range(name) if torch.autograd._profiler_enabled() else _OFF
