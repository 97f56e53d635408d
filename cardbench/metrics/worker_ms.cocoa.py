"""worker_ms.cocoa: the device ms of the program's ``local_step`` span
a round (every worker's local solve: the paper's T_worker), over the
traced solves."""
from cardbench.harness.spans import device_ms, log_of, mean


def read(run):
    log = log_of(run)
    return mean(device_ms(log, ("local_step",))) if log else None
