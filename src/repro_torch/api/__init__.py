"""``repro_torch.api``: the typed public facade over the port (the
reference's ``repro.api``).

  specs     ``ExecutionSpec`` / ``TrainSpec`` / ``ServeSpec``: frozen records
            validated at construction, with lossless ``to_dict`` /
            ``from_dict`` (a spec dict the reference wrote loads here: its
            ``"pallas"`` backend reads as ``"hopper"``)
  Session   owns params and the serving engines, resolves a spec once;
            verbs ``infer`` / ``serve`` / ``engine`` / ``serve_forever`` /
            ``train_step`` / ``evaluate``; runs on the card unless given
            ``device="cpu"``
  LiveServer / RequestHandle
            live serving: submissions while the engine runs, per-request
            futures with deadlines and cancellation
  SLORejected / DeadlineExceeded / Cancelled / QueueFull / ShutdownTimeout
            the typed request fates
  FaultPlan the seeded chaos scenario a ``ServeSpec.fault_plan`` pins
  MetricsSnapshot
            what ``LiveServer.metrics()`` returns

The layers underneath (``core.snn_model``, ``core.snn_train``,
``kernels.ops``, ``serving.engine``) stay importable and take ``spec=``;
the old kwarg-threaded helpers are deprecation shims onto this facade.
"""
from repro_torch.api.session import LiveServer, Session
from repro_torch.api.specs import (SCHEDULE_MODES, ExecutionSpec, ServeSpec,
                                   TrainSpec, spec_from_dict)
from repro_torch.obs import MetricsSnapshot
from repro_torch.runtime.faults import FaultPlan
from repro_torch.serving.futures import (Cancelled, DeadlineExceeded,
                                         QueueFull, RequestHandle,
                                         ShutdownTimeout, SLORejected)

__all__ = [
    "SCHEDULE_MODES", "ExecutionSpec", "TrainSpec", "ServeSpec",
    "spec_from_dict", "resolve_schedule",
    "Session", "LiveServer",
    "RequestHandle", "SLORejected", "DeadlineExceeded", "Cancelled",
    "QueueFull", "ShutdownTimeout", "FaultPlan", "MetricsSnapshot",
]


def resolve_schedule(flag: str, backend: str):
    """Map a CLI ``--schedule`` value onto a spec ``schedule_mode``.

    ``"auto"`` picks the kernel-level APRC+CBWS schedule exactly when the
    backend has kernel lanes to schedule (``hopper``) and no schedule
    otherwise.  Any explicit mode passes through as it is, so the spec's
    validation rejects an invalid combination loudly."""
    if flag == "auto":
        return "aprc+cbws" if backend == "hopper" else None
    return flag
