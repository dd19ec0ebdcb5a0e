"""Device-busy ms per train step in the traced stretch of the window.
Moves ``train_fps``."""


def read(run):
    steps = run.readings.get("steps_traced")
    if run.mode != "closed_train" or run.trace is None or not steps:
        return None
    return run.trace.busy_s * 1e3 / steps
