"""overhead_ms.cocoa: the program's ``round`` span's host wall less the
device ms of its ``draw``, ``local_step``, ``exchange``, ``apply`` and
``metric`` spans, a round (the paper's T_overhead), over the traced
solves."""
from cardbench.harness.spans import log_of, mean, overhead_ms


def read(run):
    log = log_of(run)
    return mean(overhead_ms(log)) if log else None
