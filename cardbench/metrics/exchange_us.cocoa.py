"""exchange_us.cocoa: the device us of the program's ``exchange`` span
a round (K2 and K3, and whatever else the exchange enqueues), over the
traced solves."""
from cardbench.harness.spans import device_ms, log_of, mean


def read(run):
    log = log_of(run)
    ms = mean(device_ms(log, ("exchange",))) if log else None
    return None if ms is None else ms * 1e3
