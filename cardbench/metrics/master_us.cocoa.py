"""master_us.cocoa: the device us of the program's ``apply`` and
``metric`` spans a round (the residual's update and the primal pass:
the paper's T_master), over the traced solves."""
from cardbench.harness.spans import device_ms, log_of, mean


def read(run):
    log = log_of(run)
    ms = mean(device_ms(log, ("apply", "metric"))) if log else None
    return None if ms is None else ms * 1e3
