"""Device ms of the counting work per ``Session.infer`` call in the traced
stretch: the device-timed spans ``repro_torch.model.counts`` (spike
counts, their permutation and cast, the outputs' sums) and
``repro_torch.model.skip_table`` over the root spans ``repro_torch.infer``;
None off the card.  Moves ``infer_fps``."""


def read(run):
    if run.mode != "closed_infer" or run.trace is None:
        return None
    try:
        from repro_torch.obs import read_spans
    except ImportError:             # a program without spans
        return None
    return read_spans().per_call("repro_torch.infer",
                                 "repro_torch.model.counts",
                                 "repro_torch.model.skip_table", device=True)
