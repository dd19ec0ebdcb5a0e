"""The kernels' share of their roofline: the least time of the work that
the traced stretch's inputs need (``skybench/work.py``, layer by layer),
over the device-busy time of the same stretch, in %.  Moves
``train_fps``."""


def read(run):
    if run.mode != "closed_train":
        return None
    return run.roofline()
