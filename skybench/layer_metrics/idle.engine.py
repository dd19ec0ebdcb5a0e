"""The share of the traced stretch in which no operation runs on the
device (the union of the profiler's device intervals), in %.  Moves
``p95_ms``."""


def read(run):
    if run.mode != "open_loop":
        return None
    return run.idle()
