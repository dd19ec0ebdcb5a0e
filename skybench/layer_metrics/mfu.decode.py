"""The whole decode step's share of the card's peak: the operations that
the window's steps need (``skybench/work_lm.py``) over the window's
seconds times 989 TFLOP/s, in %.  Moves ``decode_tok_s``."""


def read(run):
    if run.mode != "closed_decode":
        return None
    return run.mfu()
