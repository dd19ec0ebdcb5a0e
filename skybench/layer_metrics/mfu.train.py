"""The whole step's share of the card's peak: the operations that the
window's inputs need (``skybench/work.py``) over the window's seconds
times 989 TFLOP/s, in %.  Moves ``train_fps``."""


def read(run):
    if run.mode != "closed_train":
        return None
    return run.mfu()
