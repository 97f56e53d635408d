"""device_idle.cocoa: the share of the traced window in which no kernel
ran on the card, in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not any(
            op["kind"] == "solve" for op in run.ops):
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
