"""round_ms.cocoa: the trainer's own clock (``History.seconds`` over
``History.span``) over the window's untraced solves, ms a round."""


def read(run):
    traced = run.info.get("traced_solves", 0)
    ops = [op for op in run.ops if "span" in op and op["i"] > traced]
    span = sum(op["span"] for op in ops)
    if not span:
        return None
    return sum(op["seconds"] for op in ops) / span * 1e3
