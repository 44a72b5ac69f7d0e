"""The data plane a epoch, host milliseconds: ``CentralManager``'s own
``phase_seconds["execute"]`` (``PagePool.execute``: the frame table's host
loop and its ``page_move`` launches) over the traced window's epochs."""


def read(run):
    n = run.counters.get("epochs")
    return run.counters["execute_s"] / n * 1e3 if n else None
