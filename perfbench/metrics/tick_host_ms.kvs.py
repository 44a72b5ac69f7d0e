"""The manager's policy tick a epoch, host milliseconds: ``CentralManager``'s
own ``phase_seconds["tick"]`` (the ``policy.epoch_step`` call, which on the
card only enqueues the tick's work) over the traced window's epochs."""


def read(run):
    n = run.counters.get("epochs")
    return run.counters["tick_s"] / n * 1e3 if n else None
