"""Device operations (kernels, copies, sets) per decode step in the traced
stretch of the window.  Moves ``decode_tok_s``."""


def read(run):
    steps = run.readings.get("steps_traced")
    if run.mode != "closed_decode" or run.trace is None or not steps:
        return None
    return run.trace.kernels / steps
