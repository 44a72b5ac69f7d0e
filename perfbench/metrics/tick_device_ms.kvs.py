"""The manager's policy tick a epoch, device milliseconds: the card's time
in every operation launched under the ``policy.epoch_step`` entry point
(sampler, bins, FMMR, victims, queue) in the traced window, over its
epochs. Nothing when the tick launched nothing."""


def read(run):
    n = run.counters.get("epochs")
    dev_s = run.trace.device_s("tick")
    if not n or not dev_s:
        return None
    return dev_s / n * 1e3
