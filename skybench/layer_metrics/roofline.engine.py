"""The kernels' share of their roofline: the least time of the work that
the traced stretch's inputs need (``skybench/work.py``, layer by layer),
over the device-busy time of the same stretch, in %.  Moves
``p95_ms``."""


def read(run):
    if run.mode != "open_loop":
        return None
    return run.roofline()
