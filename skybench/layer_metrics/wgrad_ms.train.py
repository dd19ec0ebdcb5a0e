"""Device ms of the weight gradient per train step in the traced stretch:
the device-timed spans ``repro_torch.train.wgrad`` (each conv layer's
``conv_grad_weights``) over the root spans ``repro_torch.train_step``;
None off the card.  Moves ``train_fps``."""


def read(run):
    if run.mode != "closed_train" or run.trace is None:
        return None
    try:
        from repro_torch.obs import read_spans
    except ImportError:             # a program without spans
        return None
    return read_spans().per_call("repro_torch.train_step",
                                 "repro_torch.train.wgrad", device=True)
