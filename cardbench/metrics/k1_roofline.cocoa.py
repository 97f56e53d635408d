"""k1_roofline.cocoa: K1's bound (the yardstick's ``kernel_bounds`` on
each traced round's own draw, their mean times the K1 launches the
trace kept) over K1's device time in the trace, in %."""
from cardbench.harness.names import k1
from cardbench.yardstick.bounds import kernel_bounds
from cardbench.yardstick.streams import traced_draws


def read(run):
    tr = run.trace
    if tr is None:
        return None
    us, launches = tr.kernel_us(k1)
    drawn = traced_draws(run)
    if not launches or not drawn:
        return None
    bound_ms = sum(kernel_bounds(idx, run.info["n_pad"], run.info["m"],
                                 1)[0]["scd_solve"][0] for idx in drawn)
    return 100.0 * bound_ms * launches / len(drawn) / (us / 1e3)
