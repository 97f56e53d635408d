"""mfu.cocoa: the whole round's share of the card's peak: the sum of
every traced round's bounds (K1 on its own draw, K2 and K3 on the
(K, m) stack, the residual apply and the primal pass) over the traced
window's time, in %."""
from cardbench.yardstick.bounds import cocoa_round_rest_ms, kernel_bounds
from cardbench.yardstick.streams import traced_draws


def read(run):
    tr = run.trace
    drawn = traced_draws(run) if tr is not None else []
    if not drawn or tr.window_s <= 0:
        return None
    K, n_pad, m = run.info["K"], run.info["n_pad"], run.info["m"]
    rest = cocoa_round_rest_ms(K, n_pad, m)
    total = 0.0
    for idx in drawn:
        b = kernel_bounds(idx, n_pad, m, 1)[0]
        total += b["scd_solve"][0] + b["int8"][0] + b["decode_int8"][0] + rest
    return 100.0 * total / (tr.window_s * 1e3)
