"""The share of the traced stretch in which no operation runs on the
device (the union of the profiler's device intervals), in %.  Moves
``infer_fps``."""


def read(run):
    if run.mode != "closed_infer":
        return None
    return run.idle()
