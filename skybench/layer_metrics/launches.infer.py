"""Device operations (kernels, copies, sets) per ``Session.infer`` call in
the traced stretch of the window.  Moves ``infer_fps``."""


def read(run):
    calls = run.readings.get("calls_traced")
    if run.mode != "closed_infer" or run.trace is None or not calls:
        return None
    return run.trace.kernels / calls
