"""Host ms of the outputs' copies to the host per ``Session.infer`` call
in the traced stretch, after the wait for the device: the spans
``repro_torch.infer.readback`` over the root spans ``repro_torch.infer``.
Moves ``infer_fps``."""


def read(run):
    if run.mode != "closed_infer" or run.trace is None:
        return None
    try:
        from repro_torch.obs import read_spans
    except ImportError:             # a program without spans
        return None
    return read_spans().per_call("repro_torch.infer",
                                 "repro_torch.infer.readback")
