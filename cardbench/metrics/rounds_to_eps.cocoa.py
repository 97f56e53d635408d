"""rounds_to_eps.cocoa: the mean rounds the window's solves took to the
target (``History.rounds_to``)."""


def read(run):
    r = [op["rounds_to_eps"] for op in run.ops
         if op.get("rounds_to_eps") is not None]
    return sum(r) / len(r) if r else None
