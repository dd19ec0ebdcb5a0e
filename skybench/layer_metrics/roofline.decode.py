"""The kernels' share of their roofline in decode: the least time of the
work that the traced steps need (``skybench/work_lm.py``: the weights a
step must read, the occupied experts only, the KV cache, and their
operations), over the device-busy time of the same stretch, in %.  Moves
``decode_tok_s``."""


def read(run):
    if run.mode != "closed_decode":
        return None
    return run.roofline()
