"""``page_move``'s share of its roofline, %: the bytes its calls need
(``costs.page_move_bytes``: each moving row read and written once, and the
ids) over the H100's HBM bandwidth, against the device time of every
operation launched under the ``ops.page_move`` entry point in the traced
window. Nothing when no call moved a row."""
from perfbench import peaks


def read(run):
    nbytes = run.counters.get("page_move_bytes")
    dev_s = run.trace.device_s("page_move")
    if not nbytes or not dev_s:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / dev_s
