"""Host ms of the program's staging per ``Session.infer`` call in the
traced stretch: the spans ``repro_torch.infer.stage`` (the frames made
float32, listed and padded, then copied to the device) over the root spans
``repro_torch.infer``.  Moves ``infer_fps``."""


def read(run):
    if run.mode != "closed_infer" or run.trace is None:
        return None
    try:
        from repro_torch.obs import read_spans
    except ImportError:             # a program without spans
        return None
    return read_spans().per_call("repro_torch.infer",
                                 "repro_torch.infer.stage")
