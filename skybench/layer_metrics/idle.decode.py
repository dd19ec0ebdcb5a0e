"""The share of the traced stretch of decode steps in which no operation
runs on the device (the union of the profiler's device intervals), in %.
Moves ``decode_tok_s``."""


def read(run):
    if run.mode != "closed_decode":
        return None
    return run.idle()
