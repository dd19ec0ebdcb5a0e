"""Host ms of a train step's launches in the traced stretch: the spans
``repro_torch.train.forward``, ``repro_torch.train.backward`` and
``repro_torch.train.update`` over the root spans
``repro_torch.train_step``.  Moves ``train_fps``."""


def read(run):
    if run.mode != "closed_train" or run.trace is None:
        return None
    try:
        from repro_torch.obs import read_spans
    except ImportError:             # a program without spans
        return None
    return read_spans().per_call("repro_torch.train_step",
                                 "repro_torch.train.forward",
                                 "repro_torch.train.backward",
                                 "repro_torch.train.update")
