"""Typed execution specs: the facade's validated configuration records
(the reference's ``repro.api.specs``).

One frozen dataclass per way of running a Skydiver model:

  ``ExecutionSpec``  how a forward pass executes (backend, timesteps,
                     surrogate, kernel-level CBWS schedule, chunking)
  ``TrainSpec``      ExecutionSpec + the optimizer's knobs (surrogate-
                     gradient SGD with momentum, ``core.snn_train``)
  ``ServeSpec``      ExecutionSpec + the serving engine's lane, bucket,
                     admission and SLO knobs (``serving.engine``)

Every spec validates at construction: an unknown backend, surrogate,
schedule or admission name raises at once, and the error names the valid
set.  ``to_dict``/``from_dict`` round-trip losslessly, through JSON too
(tuples become lists and come back); ``spec_from_dict`` dispatches on the
embedded ``kind`` tag.

The kernel backend is ``"hopper"``, the hand-written CUDA kernels; the
reference calls its kernel backend ``"pallas"``.  ``from_dict`` reads
``"pallas"`` as ``"hopper"``, so a spec file the reference wrote loads
here; a spec built in code names ``"hopper"``.  A kernel-level CBWS
``schedule_mode`` exists only on the kernel backend (it permutes the
weights into the kernels' lane slices), so requesting it with
``ref``/``batched`` is a loud error rather than a silent no-op.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

__all__ = ["SCHEDULE_MODES", "ExecutionSpec", "TrainSpec", "ServeSpec",
           "spec_from_dict"]

#: Kernel-level CBWS schedule modes (core.scheduler.build_schedule), plus
#: None = "no schedule".  "none" is accepted as a spelled-out synonym so
#: config files never need a JSON null.
SCHEDULE_MODES = ("none", "cbws", "aprc+cbws")

#: The reference's names of backends that the port calls otherwise.
_REFERENCE_BACKENDS = {"pallas": "hopper"}

_SLO_ACTIONS = ("reject", "degrade")


def _check_choice(name: str, value, valid) -> None:
    if value not in valid:
        raise ValueError(
            f"unknown {name} {value!r}; expected one of {tuple(valid)}")


@dataclass(frozen=True)
class ExecutionSpec:
    """How one forward pass of a Skydiver model executes.

    ``timesteps=None`` means the model config's T.  ``schedule_mode``
    selects the kernel-level CBWS channel schedule and therefore requires
    ``backend="hopper"``.  ``chunk_timesteps`` runs T in segments of that
    many steps with the membranes carried between them (``None``: whole
    T); chunked execution is bit-identical to whole T.  ``mesh`` describes
    a device mesh as ordered (axis_name, size) pairs (``{"data": 4}`` and
    ``(("data", 4),)`` both canonicalize to the tuple form); ``Session``
    runs it through ``repro_torch.dist`` (``MeshRunner``, pinned lanes).
    """

    KIND = "execution"

    backend: str = "batched"
    timesteps: Optional[int] = None
    surrogate_kind: str = "fast_sigmoid"
    surrogate_alpha: float = 10.0
    schedule_mode: Optional[str] = None
    chunk_timesteps: Optional[int] = None
    mesh: Optional[Tuple[Tuple[str, int], ...]] = None

    def __post_init__(self):
        from repro_torch.core.snn_model import SNN_BACKENDS
        from repro_torch.core.surrogate import SURROGATE_KINDS
        from repro_torch.dist.mesh import normalize_mesh
        _check_choice("backend", self.backend, SNN_BACKENDS)
        _check_choice("surrogate_kind", self.surrogate_kind, SURROGATE_KINDS)
        if self.schedule_mode is not None:
            _check_choice("schedule_mode", self.schedule_mode, SCHEDULE_MODES)
        if self.resolved_schedule() is not None and self.backend != "hopper":
            raise ValueError(
                f"schedule_mode={self.schedule_mode!r} requires "
                f"backend='hopper' (the kernel backend, the reference's "
                f"'pallas': the CBWS schedule permutes weights into the "
                f"kernels' lane slices; backend {self.backend!r} has no "
                f"kernel lanes) — drop the schedule or switch the backend")
        if self.timesteps is not None and self.timesteps < 1:
            raise ValueError(
                f"timesteps must be >= 1 or None (config default), "
                f"got {self.timesteps}")
        if self.chunk_timesteps is not None and self.chunk_timesteps < 1:
            raise ValueError(
                f"chunk_timesteps must be >= 1 or None (whole-T), "
                f"got {self.chunk_timesteps}")
        if self.surrogate_alpha <= 0:
            raise ValueError(
                f"surrogate_alpha must be > 0, got {self.surrogate_alpha}")
        # canonicalize the mesh description (dicts / lists of pairs from
        # JSON -> tuple of (name, size)); pure validation, no device access
        object.__setattr__(self, "mesh", normalize_mesh(self.mesh))
        if self.mesh is not None and self.resolved_schedule() is not None:
            raise ValueError(
                "mesh and schedule_mode are mutually exclusive for now: "
                "mesh execution serves canonical weights (the CBWS kernel "
                "schedule permutes weights per device lane, which sharded "
                "params do not support yet) — drop one of the two")

    # -- derived -------------------------------------------------------------
    def resolved_schedule(self) -> Optional[str]:
        """The effective schedule mode: "none" normalizes to None."""
        return (None if self.schedule_mode in (None, "none")
                else self.schedule_mode)

    def resolved_mesh(self) -> Optional[Dict[str, int]]:
        """The mesh description as an ordered {axis: size} dict (None =
        single device)."""
        return None if self.mesh is None else dict(self.mesh)

    def execution_fields(self) -> Dict[str, Any]:
        """The ExecutionSpec subset of this spec (sub-specs inherit it)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(ExecutionSpec)}

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict (tuples listified) tagged with the spec kind."""
        d = {"kind": type(self).KIND}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                # one level of nesting suffices: mesh is ((name, size), ...)
                v = [list(e) if isinstance(e, tuple) else e for e in v]
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExecutionSpec":
        """Inverse of ``to_dict``, and the reader of the reference's spec
        dicts (its ``"pallas"`` backend is the port's ``"hopper"``).
        Unknown keys are an error naming the valid field set (a config-file
        typo must not silently vanish)."""
        d = dict(d)
        kind = d.pop("kind", cls.KIND)
        if kind != cls.KIND:
            raise ValueError(
                f"spec dict has kind={kind!r} but {cls.__name__} expects "
                f"{cls.KIND!r} (use spec_from_dict to dispatch on kind)")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(
                f"unknown {cls.__name__} field(s) {unknown}; valid fields: "
                f"{sorted(fields)}")
        if "backend" in d:
            d["backend"] = _REFERENCE_BACKENDS.get(d["backend"], d["backend"])
        for name, v in d.items():
            if isinstance(v, list):
                d[name] = tuple(v)
        return cls(**d)


@dataclass(frozen=True)
class TrainSpec(ExecutionSpec):
    """ExecutionSpec + the surrogate-gradient SGD/momentum knobs that
    ``core.snn_train.make_train_step`` consumes.  A kernel schedule is a
    deployment-time weight permutation and has no training semantics, so
    ``schedule_mode`` is rejected here; so is ``chunk_timesteps``."""

    KIND = "train"

    lr: float = 1e-3
    momentum: float = 0.9

    def __post_init__(self):
        super().__post_init__()
        if self.resolved_schedule() is not None:
            raise ValueError(
                "TrainSpec does not accept a schedule_mode: the CBWS kernel "
                "schedule permutes deployed weights and is a serving-time "
                "concept — train without it, then serve with a ServeSpec")
        if self.chunk_timesteps is not None:
            raise ValueError(
                "TrainSpec does not accept chunk_timesteps: chunk-boundary "
                "rescheduling is a serving-time concept (training always "
                "runs whole-T; chunked execution is bit-identical anyway) — "
                "train without it, then serve with a ServeSpec")
        if self.lr <= 0:
            raise ValueError(f"lr must be > 0, got {self.lr}")
        if not 0.0 <= self.momentum < 1.0:
            raise ValueError(
                f"momentum must be in [0, 1), got {self.momentum}")


@dataclass(frozen=True)
class ServeSpec(ExecutionSpec):
    """ExecutionSpec + the continuous-batching engine's configuration
    (lanes, padding buckets, admission policy, retries, threading, SLO):
    the typed way to build ``serving.EngineConfig``."""

    KIND = "serve"

    num_lanes: int = 2
    max_batch: int = 8
    buckets: Optional[Tuple[int, ...]] = None   # None -> DEFAULT_BUCKETS
    admission: str = "cbws"
    batch_aware: bool = True
    max_retries: int = 2
    retry_backoff_s: float = 0.0
    straggler_z: float = 3.0
    keep_logits: bool = True
    threaded: bool = False
    # admission-time SLO control (None disables)
    latency_budget_s: Optional[float] = None
    slo_action: str = "reject"
    degrade_timesteps: Optional[int] = None
    slo_seconds_per_work: Optional[float] = None
    slo_batch_quantum_s: Optional[float] = None
    # robustness: bounded-queue backpressure, per-request deadlines, and
    # supervised lane restart (serving.engine, serving.supervisor)
    max_queue: Optional[int] = None
    default_deadline_s: Optional[float] = None
    restart_budget: int = 0
    restart_backoff_s: float = 0.05
    hang_timeout_s: Optional[float] = None
    # deterministic seeded chaos (runtime.faults.FaultPlan); serialized as a
    # nested dict so spec files can pin a replayable scenario
    fault_plan: Optional[Any] = None
    # observability: record lifecycle events into the engine's bounded
    # trace ring buffer (obs.trace)
    trace: bool = False
    trace_capacity: int = 65536

    def __post_init__(self):
        super().__post_init__()
        from repro_torch.runtime.faults import FaultPlan
        from repro_torch.serving.admission import ADMISSION_POLICIES
        _check_choice("admission policy", self.admission, ADMISSION_POLICIES)
        _check_choice("slo_action", self.slo_action, _SLO_ACTIONS)
        if self.num_lanes < 1:
            raise ValueError(f"num_lanes must be >= 1, got {self.num_lanes}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.buckets is not None:
            if not self.buckets or any(b < 1 for b in self.buckets):
                raise ValueError(
                    f"buckets must be positive, got {self.buckets}")
            if self.max_batch > max(self.buckets):
                raise ValueError(
                    f"max_batch={self.max_batch} exceeds largest bucket "
                    f"{max(self.buckets)}")
        if self.degrade_timesteps is not None and self.degrade_timesteps < 1:
            raise ValueError(
                f"degrade_timesteps must be >= 1, "
                f"got {self.degrade_timesteps}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or None for unbounded), "
                f"got {self.max_queue}")
        if self.default_deadline_s is not None \
                and self.default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be positive, "
                f"got {self.default_deadline_s}")
        if self.restart_budget < 0:
            raise ValueError(
                f"restart_budget must be >= 0, got {self.restart_budget}")
        if self.restart_backoff_s < 0:
            raise ValueError(
                f"restart_backoff_s must be >= 0, "
                f"got {self.restart_backoff_s}")
        if self.hang_timeout_s is not None and self.hang_timeout_s <= 0:
            raise ValueError(
                f"hang_timeout_s must be positive, got {self.hang_timeout_s}")
        if self.trace_capacity < 1:
            raise ValueError(
                f"trace_capacity must be >= 1, got {self.trace_capacity}")
        if self.fault_plan is not None \
                and not isinstance(self.fault_plan, FaultPlan):
            raise ValueError(
                f"fault_plan must be a runtime.faults.FaultPlan (or None), "
                f"got {type(self.fault_plan).__name__} — dict forms go "
                f"through ServeSpec.from_dict")

    # -- (de)serialization: fault_plan is a nested dataclass the generic
    # tuple<->list walk cannot handle -----------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        if self.fault_plan is not None:
            d["fault_plan"] = self.fault_plan.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeSpec":
        from repro_torch.runtime.faults import FaultPlan
        d = dict(d)
        fp = d.get("fault_plan")
        if isinstance(fp, dict):
            d["fault_plan"] = FaultPlan.from_dict(fp)
        return super().from_dict(d)

    def to_engine_config(self, **overrides):
        """The serving engine's ``EngineConfig``: the one place the spec
        crosses into the engine layer (``overrides`` carries the engine's
        own hooks, such as ``fault_hook``, ``service_time_fn`` and
        ``device``)."""
        from repro_torch.serving.batcher import DEFAULT_BUCKETS
        from repro_torch.serving.engine import EngineConfig
        buckets = self.buckets if self.buckets is not None else DEFAULT_BUCKETS
        kw = dict(
            backend=self.backend, num_lanes=self.num_lanes,
            max_batch=self.max_batch, buckets=tuple(buckets),
            admission=self.admission, batch_aware=self.batch_aware,
            max_retries=self.max_retries,
            retry_backoff_s=self.retry_backoff_s,
            straggler_z=self.straggler_z,
            schedule_mode=self.resolved_schedule(),
            chunk_timesteps=self.chunk_timesteps,
            keep_logits=self.keep_logits, threaded=self.threaded,
            latency_budget_s=self.latency_budget_s,
            slo_action=self.slo_action,
            degrade_timesteps=self.degrade_timesteps,
            slo_seconds_per_work=self.slo_seconds_per_work,
            slo_batch_quantum_s=self.slo_batch_quantum_s,
            max_queue=self.max_queue,
            default_deadline_s=self.default_deadline_s,
            restart_budget=self.restart_budget,
            restart_backoff_s=self.restart_backoff_s,
            hang_timeout_s=self.hang_timeout_s,
            fault_plan=self.fault_plan,
            trace=self.trace,
            trace_capacity=self.trace_capacity,
        )
        kw.update(overrides)
        return EngineConfig(**kw)


_KINDS = {cls.KIND: cls for cls in (ExecutionSpec, TrainSpec, ServeSpec)}


def spec_from_dict(d: Dict[str, Any]):
    """Rebuild any spec from its ``to_dict`` form (the port's or the
    reference's), dispatching on ``kind``."""
    kind = d.get("kind", ExecutionSpec.KIND)
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown spec kind {kind!r}; expected one of {sorted(_KINDS)}")
    return cls.from_dict(d)
