"""time_to_eps_ms: the window's wall time over the solves that reached
the target (host clock). The window runs from the first solve's start
to the end of the last solve started before the run's seconds ran out."""


def read(run):
    done = [op for op in run.ops if op["kind"] == "solve" and op["ok"]]
    if not done:
        return None
    return (run.window[1] - run.window[0]) / len(done) * 1e3
