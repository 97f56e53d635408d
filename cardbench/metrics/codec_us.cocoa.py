"""codec_us.cocoa: the exchange's device time a round, K2 (encode) and
K3 (decode and sum) by kernel name, in microseconds."""
from cardbench.harness.names import k2, k3


def read(run):
    tr = run.trace
    if tr is None:
        return None
    rounds = sum(op.get("rounds", 0) for op in run.ops
                 if op["i"] <= run.info.get("traced_solves", 0))
    us2, n2 = tr.kernel_us(k2)
    us3, n3 = tr.kernel_us(k3)
    if not rounds or not n2 or not n3:
        return None
    return (us2 + us3) / rounds
