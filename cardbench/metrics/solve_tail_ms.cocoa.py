"""solve_tail_ms.cocoa: the program's ``solve`` span's host wall less
its ``round`` spans' (the set-up and ``finish`` that time_to_eps_ms
pays and round_ms.cocoa does not), a solve, over the traced solves."""
from cardbench.harness.spans import log_of, mean, solve_tail_ms


def read(run):
    log = log_of(run)
    return mean(solve_tail_ms(log)) if log else None
