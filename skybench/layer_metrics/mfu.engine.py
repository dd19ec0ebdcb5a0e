"""The engine's share of the card's peak while it computes: the operations
that its micro-batches' frames need (``skybench/work.py``) over the seconds
in which a micro-batch was in flight on a lane (from the engine's
``batch_done`` events), at 989 TFLOP/s, in %.  Moves ``p95_ms``."""


def read(run):
    if run.mode != "open_loop":
        return None
    return run.mfu_batches()
