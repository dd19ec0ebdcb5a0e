"""The continuous-batching serving engine.

One event loop, two clocks (``serving.clock``):

``run()`` with the default **VirtualClock** replays the submitted load trace
deterministically (service times measured on the wall — or injected via
``service_time_fn`` — and queueing simulated on arrival timestamps), the
historical PR-2 semantics and what tier-1 tests replay bit-identically.

``run()`` with ``EngineConfig.threaded=True`` promotes the loop to a real
concurrent engine on the **WallClock**: every lane is a worker thread that
owns its *own* exec cache (forked from one warmed shared cache before the
clock epoch — the kernels are built and every entry run once before it,
so warmup never pollutes latency), fed micro-batches through a per-lane
inbox and reporting over a shared completion queue.  The scheduler thread
replays arrivals on the wall, forms FIFO windows whenever lanes are idle,
CBWS-bins them (admission.admit), and parks between arrival/completion
events.  Lane execution (pad, forward, host copy of the outputs) happens
entirely on the worker threads, each launching on the device's current
stream.

Admission-time SLO control (``EngineConfig.latency_budget_s``): the
APRC-predicted workload already prices each request, so the admitter
estimates per-request queue delay from the straggler monitor's measured
seconds-per-work and rejects — or degrades to fewer timesteps — requests
whose predicted latency exceeds the budget (``admission.slo_filter``).

  submit()          frames + arrival times -> FIFO queue, with the request's
                    APRC-predicted workload attached at admission
  run()             drain the queue (virtual or threaded, see above)
  serve_forever()   live mode (threaded only): start the scheduler in the
                    background and accept ``submit_live()`` while running —
                    each live submission returns a future-style
                    ``RequestHandle`` (serving.futures) that resolves with
                    the request's logits, fails with ``SLORejected`` at
                    admission, or fails with the engine error if all lanes
                    die.  ``shutdown()`` refuses new submissions, drains the
                    queue and every in-flight micro-batch, joins the
                    scheduler, and returns the metrics summary.
  infer()           single-shot mode: one batch through the same exec cache
  infer_pipelined() throughput mode: N batches launched without a per-batch
                    host sync, then one synchronize

This is the port of ``repro.serving.engine``.  Until the port has the
reference's facade (``ServeSpec``, ``Session``), ``EngineConfig`` is built
directly (``repro_torch.launch.serve --engine`` does).  The engine runs
where ``EngineConfig.device`` says: the card unless it names the CPU.
Service times on the wall clock are read after the outputs are on the
host, so the SLO delay model learns device time, not launch time.

Lane failures (injected via ``EngineConfig.fault_hook`` / a seeded
``EngineConfig.fault_plan``, or real) burn the retry budget in
``runtime.fault_tolerance``; a dead lane's micro-batch is re-queued at the
FIFO head and served by the survivors — in the threaded engine the kill
lands mid-flight on the worker thread and the batch drains back through the
completion queue, so no request is ever lost or served twice
(tests/test_serving_threaded.py and tests/test_serving_faults.py chaos-test
this).  With ``EngineConfig.restart_budget > 0`` the threaded engine's
scheduler additionally *supervises* its lanes (``serving.supervisor``): a
dead lane is restarted with a fresh warmed cache fork after an exponential
capped backoff, up to the budget, and only then stays dead; hung workers
(``hang_timeout_s``) are escalated to deaths via heartbeats.  Requests can
carry deadlines (failed with ``DeadlineExceeded`` when they expire in queue
or price unmeetable), live handles can be cancelled, and the live queue can
be bounded (``max_queue`` -> ``QueueFull`` at submit) — every outcome
resolves each request exactly once.

Padding correctness: micro-batches pad up to bucket sizes with zero frames.
Zero-init biases keep pad rows silent, but *trained* supra-threshold biases
make them fire; ``_accumulate`` subtracts the deterministic zero-frame spike
profile per pad row so spike-count/energy metrics stay exact (logits were
always sliced, so correctness never depended on this).  A row's logits do
not depend on the batch or bucket it ran in (``core.snn_layers``), so pad
rows never change a served row.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import SNNConfig
from repro_torch.core.balance import balance_ratio
from repro_torch.core.snn_model import ChunkCarry
from repro_torch.device import resolve_device
from repro_torch.obs import trace as trc
from repro_torch.obs.snapshot import MetricsSnapshot
from repro_torch.obs.trace import TraceRecorder
from repro_torch.runtime.fault_tolerance import RetryPolicy
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.serving import admission
from repro_torch.serving.batcher import (DEFAULT_BUCKETS, DynamicBatcher,
                                         ExecCache, bucket_for, pad_frames,
                                         to_device, to_host)
from repro_torch.serving.clock import Clock, VirtualClock, WallClock
from repro_torch.serving.dispatch import LaneDispatcher, LaneFailed
from repro_torch.serving.futures import (Cancelled, DeadlineExceeded,
                                         QueueFull, RequestHandle,
                                         ShutdownTimeout, SLORejected)
from repro_torch.serving.metrics import ServingMetrics, energy_per_image
from repro_torch.serving.request import Request
from repro_torch.serving.supervisor import LaneSupervisor

__all__ = ["EngineConfig", "ServingEngine"]

SLO_ACTIONS = ("reject", "degrade")


def _map_carry(fn, carry: ChunkCarry) -> ChunkCarry:
    """``fn`` on every array of a (host) ChunkCarry."""
    return ChunkCarry(conv_v=tuple(fn(a) for a in carry.conv_v),
                      dense_v=tuple(fn(a) for a in carry.dense_v),
                      readout_v=fn(carry.readout_v))


@dataclass(frozen=True)
class EngineConfig:
    backend: str = "batched"            # core.snn_model backend
    num_lanes: int = 2                  # K replica / micro-batch lanes
    max_batch: int = 8                  # per-lane micro-batch cap
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    admission: str = "cbws"             # "cbws" | "fifo" (baseline)
    batch_aware: bool = True            # plan group sizes onto buckets
    max_retries: int = 2                # lane failure retry budget
    retry_backoff_s: float = 0.0        # sleep between attempts (threaded
                                        # lanes yield the core; keep 0 for
                                        # deterministic virtual replay)
    straggler_z: float = 3.0
    schedule_mode: Optional[str] = None  # CBWS kernel schedule (hopper)
    keep_logits: bool = True            # per-request logits on the Request
    # timestep-chunked continuous batching: run each request's T in chunks
    # of this many timesteps and reschedule at every chunk boundary — new
    # arrivals join a running lane's next chunk, finished/cancelled/expired
    # requests are evicted mid-flight, and SLO degrade truncates remaining
    # chunks instead of acting only at admission.  Chunked execution is
    # bit-identical to whole-T (the chunk-parity contract,
    # tests/test_chunk_parity.py).  None = historical whole-T dispatch.
    chunk_timesteps: Optional[int] = None
    # real concurrency: lanes as worker threads on the wall clock
    threaded: bool = False
    # multi-device serving: one device per lane.  Needs the port of the
    # reference's mesh runtime (repro.dist, ROADMAP queue 1 item 11); any
    # value but None raises until then
    lane_devices: Optional[Tuple[object, ...]] = None
    # where the engine runs (its params are moved there): None = the card
    device: Optional[str] = None
    # admission-time SLO control (None disables)
    latency_budget_s: Optional[float] = None
    slo_action: str = "reject"          # "reject" | "degrade"
    degrade_timesteps: Optional[int] = None   # default: max(1, T // 2)
    # prior s-per-unit-workload for the delay predictor; None learns it from
    # the straggler monitor's measured EWMAs (admit-all until first sample)
    slo_seconds_per_work: Optional[float] = None
    # per-batch time quantum (intercept) of the delay model: dispatch + pad
    # + launch overhead that every micro-batch pays regardless of its work.
    # None learns it by fitting svc = quantum + rate * work over measured
    # micro-batches; splitting the quantum out of the rate un-inflates the
    # marginal seconds-per-work, so tight budgets admit more (the historical
    # quantum-free model priced the fixed cost once per *request*)
    slo_batch_quantum_s: Optional[float] = None
    # bounded-queue backpressure: submit_live() raises QueueFull once this
    # many requests are already queued (None = unbounded, historical)
    max_queue: Optional[int] = None
    # default per-request deadline (s after arrival) applied to submissions
    # that don't carry their own; None = no deadline unless the client sets
    # one (Request.deadline_s)
    default_deadline_s: Optional[float] = None
    # lane supervision (threaded engine): restarts per lane before a death
    # becomes permanent, base of the exponential capped restart backoff, and
    # the heartbeat silence after which a busy lane is presumed hung (None
    # disables hang detection).  restart_budget=0 keeps the historical
    # one-way-death semantics.
    restart_budget: int = 0
    restart_backoff_s: float = 0.05
    hang_timeout_s: Optional[float] = None
    # test/chaos hooks
    fault_hook: Optional[Callable[[int, int], None]] = None
    # deterministic seeded chaos (runtime.faults): crashes/transients become
    # the dispatcher fault hook (chained before fault_hook), slow lanes scale
    # service time.  Storms are the caller's (FaultPlan.storm_arrivals).
    fault_plan: Optional[FaultPlan] = None
    # maps (lane, measured wall s) -> virtual service s; tests inject
    # deterministic lane speeds here, default is the wall measurement
    # (virtual clock only — the threaded engine serves on measured time).
    # A 3-arg callable additionally receives the dispatched timestep count
    # (the chunk length under chunk_timesteps, else the request T) so
    # deterministic service models can price partial-T dispatches
    service_time_fn: Optional[Callable[..., float]] = None
    # lifecycle tracing (obs.trace): record typed events into a bounded
    # ring buffer on the engine clock.  Off by default — call sites emit
    # unconditionally but a disabled recorder returns after one attribute
    # check, so untraced engines pay nothing.
    trace: bool = False
    trace_capacity: int = 65536


class ServingEngine:
    # lock discipline (checked by repro.analysis rule "lock-discipline"):
    # the three locks and what they guard — see docs/serving.md.  Accesses
    # that are safe without the lock (e.g. monotonic sticky-error reads)
    # carry explicit "# lint: allow(lock-discipline)" annotations.
    _GUARDED_BY = {
        "_futures": "_futures_lock",
        "_next_rid": "_rid_lock",
        "_live_error": "_submit_lock",
    }

    def __init__(self, params: Dict, cfg: SNNConfig, ecfg: EngineConfig):
        if ecfg.admission not in admission.ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {ecfg.admission!r}")
        if ecfg.slo_action not in SLO_ACTIONS:
            raise ValueError(f"unknown slo_action {ecfg.slo_action!r}; "
                             f"expected {SLO_ACTIONS}")
        if ecfg.degrade_timesteps is not None and ecfg.degrade_timesteps < 1:
            raise ValueError(
                f"degrade_timesteps must be >= 1, got {ecfg.degrade_timesteps}"
                " (a zero-timestep network cannot run)")
        if ecfg.chunk_timesteps is not None and ecfg.chunk_timesteps < 1:
            raise ValueError(
                f"chunk_timesteps must be >= 1 (or None for whole-T "
                f"dispatch), got {ecfg.chunk_timesteps}")
        if ecfg.max_queue is not None and ecfg.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or None for unbounded), "
                f"got {ecfg.max_queue}")
        if ecfg.default_deadline_s is not None and ecfg.default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be positive, "
                f"got {ecfg.default_deadline_s}")
        if ecfg.restart_budget < 0:
            raise ValueError(
                f"restart_budget must be >= 0, got {ecfg.restart_budget}")
        if ecfg.restart_backoff_s < 0:
            raise ValueError(
                f"restart_backoff_s must be >= 0, got {ecfg.restart_backoff_s}")
        if ecfg.trace_capacity < 1:
            raise ValueError(
                f"trace_capacity must be >= 1, got {ecfg.trace_capacity}")
        if ecfg.lane_devices is not None:
            raise NotImplementedError(
                "EngineConfig.lane_devices: one device per lane needs the "
                "port of the mesh runtime (repro.dist, ROADMAP queue 1 item "
                "11); leave it None")
        self.device = resolve_device(ecfg.device)
        self.cfg = cfg
        self.ecfg = ecfg
        # service_time_fn arity, resolved once: 3-arg models also see the
        # dispatched timestep count (chunk length under chunk_timesteps)
        self._svc_fn_takes_t = False
        if ecfg.service_time_fn is not None:
            import inspect
            try:
                sig = inspect.signature(ecfg.service_time_fn)
                self._svc_fn_takes_t = len([
                    p for p in sig.parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)]) >= 3
            except (TypeError, ValueError):
                pass
        self._schedule = None
        if ecfg.schedule_mode is not None:
            from repro_torch.core import build_schedule
            self._schedule = build_schedule(params, cfg, ecfg.schedule_mode)
        self.cache = ExecCache(params, cfg, schedule=self._schedule,
                               chunk_timesteps=ecfg.chunk_timesteps,
                               device=self.device)
        self.params = self.cache.params     # on the engine's device
        # obs-facing lane -> device labels (snapshot / dispatch trace events)
        self._lane_device_strs: Tuple[str, ...] = (
            () if ecfg.lane_devices is None
            else tuple(str(d) for d in ecfg.lane_devices))
        self.batcher = DynamicBatcher(ecfg.max_batch, ecfg.buckets)
        # seeded chaos: the plan's crash/transient hook chains *before* any
        # user fault_hook; slow-lane multipliers are queried at service time
        self._injector: Optional[FaultInjector] = None
        hook = ecfg.fault_hook
        if ecfg.fault_plan is not None:
            self._injector = FaultInjector(ecfg.fault_plan, ecfg.num_lanes)
            hook = self._injector.chain(ecfg.fault_hook)
        self.dispatcher = LaneDispatcher(
            ecfg.num_lanes,
            retry=RetryPolicy(max_retries=ecfg.max_retries,
                              backoff_s=ecfg.retry_backoff_s),
            straggler_z=ecfg.straggler_z, fault_hook=hook,
            sleep_fn=self._retry_sleep)
        self.supervisor = LaneSupervisor(
            ecfg.num_lanes, restart_budget=ecfg.restart_budget,
            policy=RetryPolicy(backoff_s=ecfg.restart_backoff_s),
            hang_timeout_s=ecfg.hang_timeout_s)
        self.metrics = ServingMetrics()
        # one recorder for the engine's lifetime; emit is a no-op when
        # EngineConfig.trace is off (call sites stay unconditional)
        self.trace = TraceRecorder(capacity=ecfg.trace_capacity,
                                   enabled=ecfg.trace)
        self.completed: List[Request] = []
        self.rejected: List[Request] = []
        self.expired: List[Request] = []   # deadline-expired in queue
        self._chan_w = admission.layer0_channel_weights(params)
        self._next_rid = 0
        self._submitted: List[Request] = []
        # accumulated actual spike workload per conv layer, (T, Cout),
        # pad-row contributions masked out
        self._tc_accum: Optional[List[np.ndarray]] = None
        # per-timesteps zero-frame spike profile (the per-pad-row counts);
        # chunked entries are keyed ("chunk", chunk_len) — pad rows restart
        # every chunk from zero carry, so one profile per length is exact
        self._pad_profiles: Dict[object, List[np.ndarray]] = {}
        self._degrade_t = (ecfg.degrade_timesteps
                           if ecfg.degrade_timesteps is not None
                           else max(1, cfg.timesteps // 2))
        if ecfg.chunk_timesteps is not None:
            # chunk-align the degrade target (round up, capped at T) so
            # every degraded request's chunk sequence stays inside the
            # warmable length set {chunk, T % chunk} — an unaligned target
            # would build a fresh remainder entry per target
            ct = ecfg.chunk_timesteps
            self._degrade_t = min(cfg.timesteps,
                                  -(-self._degrade_t // ct) * ct)
        # all-zero ChunkCarry row template (chunked mode), built lazily:
        # fresh requests and pad rows start every chunk from this state
        self._zero_carry = None
        self._lane_caches: Optional[List[ExecCache]] = None
        self._lane_compiles = 0           # threaded per-lane cache compiles
        # measured (predicted work, service s) per micro-batch — the delay
        # model's fit set (quantum + marginal rate, see _delay_model)
        self._svc_samples: deque = deque(maxlen=256)
        # live serving (serve_forever) state
        self._futures: Dict[int, RequestHandle] = {}
        self._futures_lock = threading.Lock()
        self._rid_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._completions: Optional["queue_mod.Queue"] = None
        self._stop: Optional[threading.Event] = None
        self._live_clock: Optional[WallClock] = None
        self._live_thread: Optional[threading.Thread] = None
        self._live_error: Optional[BaseException] = None
        self._live_summary: Optional[Dict[str, float]] = None
        # the clock of the currently-running engine loop (virtual or wall);
        # retry backoff routes through it so virtual fault replays never
        # wall-sleep (runtime.fault_tolerance.call_with_retry sleep_fn)
        self._clock: Optional[Clock] = None

    def _retry_sleep(self, seconds: float) -> None:
        """Retry-backoff sleep for the dispatcher, routed through the
        engine's clock: deterministic advance under VirtualClock, a real
        sleep under WallClock (a fresh WallClock when called before any
        loop starts, e.g. dispatcher used standalone)."""
        clock = self._clock if self._clock is not None else WallClock()
        clock.sleep_until(clock.now() + seconds)

    # -- submission ---------------------------------------------------------
    def _make_request(self, frame: np.ndarray, arrival: float,
                      deadline_s: Optional[float] = None) -> Request:
        frame = np.asarray(frame, dtype=np.float32)
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        if deadline_s is None:
            deadline_s = self.ecfg.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        return Request(
            rid=rid, frame=frame, arrival=float(arrival),
            deadline_s=None if deadline_s is None else float(deadline_s),
            workload=admission.predict_workload(frame, self._chan_w,
                                                self.cfg.timesteps),
            events=float(self.cfg.timesteps) * float(frame.sum()))

    def submit(self, frame: np.ndarray, arrival: float = 0.0,
               deadline_s: Optional[float] = None) -> int:
        if self._live_thread is not None:
            # the trace list is snapshotted once when the scheduler starts —
            # appending now would silently black-hole the request
            raise RuntimeError(
                "engine is live (serve_forever running): use submit_live() "
                "— trace submit() is only read when run()/serve_forever() "
                "starts")
        req = self._make_request(frame, arrival, deadline_s)
        self._submitted.append(req)
        # stamped at the request's arrival (not "now"): pre-run submissions
        # replay deterministically under the virtual clock
        self.trace.emit(trc.KIND_SUBMIT, t=req.arrival, rid=req.rid,
                        workload=req.workload, deadline_s=req.deadline_s)
        return req.rid

    def submit_live(self, frame: np.ndarray,
                    deadline_s: Optional[float] = None) -> RequestHandle:
        """Submit one frame to a *running* engine (``serve_forever``).

        Returns a future-style ``RequestHandle``: ``result(timeout)`` blocks
        for the logits, raises ``SLORejected`` if admission dropped the
        request, ``DeadlineExceeded``/``Cancelled`` per the handle's fate,
        or re-raises the engine failure if serving died.  ``deadline_s``
        (seconds after arrival; default ``EngineConfig.default_deadline_s``)
        is the client's latency contract.  Raises ``QueueFull`` *here* —
        fail-fast backpressure, no handle created — when the bounded queue
        (``EngineConfig.max_queue``) is at capacity.  Arrival is stamped off
        the live wall clock; thread-safe (any client thread may call this
        concurrently).
        """
        if self._live_thread is None or self._stop is None:
            raise RuntimeError(
                "engine is not live — call serve_forever() first "
                "(run() drains a pre-submitted trace instead)")
        with self._submit_lock:
            # the stop check and the queue push are atomic w.r.t. shutdown()
            # and the scheduler's death path: a request admitted here is
            # guaranteed to be drained or failed, never silently dropped
            if self._live_error is not None:
                raise RuntimeError(
                    "live serving died") from self._live_error
            if self._stop.is_set():
                raise RuntimeError(
                    "engine is shutting down; no new submissions")
            depth = len(self.batcher)
            if self.ecfg.max_queue is not None \
                    and depth >= self.ecfg.max_queue:
                self.metrics.queue_full += 1
                self.trace.emit(trc.KIND_QUEUE_FULL,
                                t=self._live_clock.now(), depth=depth)
                raise QueueFull(depth, self.ecfg.max_queue)
            req = self._make_request(frame, self._live_clock.now(),
                                     deadline_s)
            handle = RequestHandle(req)
            handle._canceller = lambda rid=req.rid: self._cancel_live(rid)
            with self._futures_lock:
                self._futures[req.rid] = handle
            self.batcher.push(req)
            self.metrics.note_depth(depth + 1)
            self.trace.emit(trc.KIND_SUBMIT, t=req.arrival, rid=req.rid,
                            workload=req.workload, deadline_s=req.deadline_s)
        self._completions.put(("wake",))      # unpark the scheduler
        return handle

    def _cancel_live(self, rid: int) -> bool:
        """Attempt a client cancel (``RequestHandle.cancel``).  The
        ``in_flight`` check and the handle pop are atomic under the futures
        lock — the same lock dispatch takes to set ``in_flight`` — so a
        cancel either wins (handle fails ``Cancelled``, the queued request
        is dropped at the next sweep) or cleanly refuses; it can never race
        a dispatch into a double resolution."""
        with self._futures_lock:
            h = self._futures.get(rid)
            if h is None or h.request.in_flight:
                return False
            del self._futures[rid]
            h.request.cancelled = True
        self.metrics.cancelled += 1
        self.trace.emit(
            trc.KIND_CANCEL, rid=rid,
            t=self._live_clock.now() if self._live_clock is not None
            else None)
        h._fail(Cancelled(h.request))
        if self._completions is not None:
            self._completions.put(("wake",))   # let the scheduler sweep it
        return True

    def update_params(self, params: Dict) -> None:
        """Swap the served params in place (same pytree structure).

        Cache entries are params-*independent* — every cache passes params
        as an argument — so no entry is rebuilt; only the params-derived
        caches (zero-frame pad profiles, channel weights for APRC
        admission) must refresh.  The one exception is a CBWS kernel
        schedule (``schedule_mode``): the permutation is closed over by the
        entries and is itself derived from the params, so scheduled engines
        rebuild it AND drop their entries (rebuilt on next use with the
        fresh schedule).  Not allowed on a live engine: in-flight
        micro-batches would mix parameter versions.
        """
        if self._live_thread is not None:
            raise RuntimeError(
                "cannot update params while serve_forever is running")
        caches = [self.cache] + (self._lane_caches or [])
        if self.ecfg.schedule_mode is not None:
            from repro_torch.core import build_schedule
            self._schedule = build_schedule(params, self.cfg,
                                            self.ecfg.schedule_mode)
            for c in caches:
                c.schedule = self._schedule
                c._fns.clear()            # old schedule is closed over
        for c in caches:
            c.params = params
        self.params = self.cache.params
        self._pad_profiles.clear()
        self._chan_w = admission.layer0_channel_weights(params)

    # -- future resolution ---------------------------------------------------
    def _pop_handle(self, rid: int) -> Optional[RequestHandle]:
        with self._futures_lock:
            return self._futures.pop(rid, None)

    def _finish_request(self, r: Request, logits_row: np.ndarray) -> None:
        """A request completed: record it and resolve its live handle (if
        any) — each handle resolves exactly once (conservation)."""
        self.completed.append(r)
        self.trace.emit(trc.KIND_COMPLETE, t=r.finish, rid=r.rid,
                        lane=r.lane if r.lane >= 0 else None,
                        latency=r.finish - r.arrival)
        h = self._pop_handle(r.rid)
        if h is not None:
            h._resolve(np.array(logits_row, copy=True))

    def _fail_rejected(self, rejected: Sequence[Request],
                       now: Optional[float] = None) -> None:
        """Admission drops: ``DeadlineExceeded`` when the request's own
        deadline was the binding constraint (``slo_filter`` flags it),
        ``SLORejected`` when the engine-wide budget was."""
        for r in rejected:
            if r.deadline_missed:
                self.metrics.deadline_missed += 1
                self.trace.emit(trc.KIND_DEADLINE, t=now, rid=r.rid,
                                reason="unmeetable")
            else:
                self.trace.emit(trc.KIND_REJECT, t=now, rid=r.rid,
                                reason="slo_budget")
            h = self._pop_handle(r.rid)
            if h is not None:
                h._fail(DeadlineExceeded(r) if r.deadline_missed
                        else SLORejected(r))

    def _fail_expired(self, expired: Sequence[Request],
                      now: Optional[float] = None) -> None:
        """Queue-expired requests: the deadline passed before dispatch."""
        for r in expired:
            r.deadline_missed = True
            self.metrics.deadline_missed += 1
            self.expired.append(r)
            self.trace.emit(trc.KIND_DEADLINE, t=now, rid=r.rid,
                            reason="expired_in_queue")
            h = self._pop_handle(r.rid)
            if h is not None:
                h._fail(DeadlineExceeded(r))

    def _sweep_queue(self, now: float) -> None:
        """Drop cancelled/expired requests from the FIFO queue.  Cancelled
        handles already failed inside ``cancel()``; expired ones fail here
        with ``DeadlineExceeded`` — either way the request leaves the system
        having resolved exactly once.  Runs at every scheduler wake, so the
        queue-depth watermark sample here closes the historical gap where
        spikes between admission rounds went unrecorded."""
        swept = self.batcher.sweep(now)
        self.metrics.note_depth(len(self.batcher) + len(swept))
        if swept:
            for r in swept:
                self._note_mid_evict(
                    r, "cancelled" if r.cancelled else "expired", now)
            self._fail_expired([r for r in swept if not r.cancelled],
                               now=now)
            self.trace.emit(trc.KIND_SWEEP, t=now, dropped=len(swept))

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Engine-fatal: every unresolved live handle fails with the cause
        (clients blocked in result() must not hang forever)."""
        with self._futures_lock:
            handles = list(self._futures.values())
            self._futures.clear()
        for h in handles:
            self.trace.emit(trc.KIND_FAILED, rid=h.request.rid,
                            error=type(exc).__name__)
            h._fail(exc)

    # -- execution ----------------------------------------------------------
    def _eff_work(self, r: Request) -> float:
        """Predicted work of the request's *next dispatch* — Eq. 5's
        workload factorizes over T.  Whole-T mode: the (possibly degraded)
        full timestep count.  Chunked mode: the next chunk's length, so
        micro-batch work, lane backlog, and the delay model's (work, svc)
        samples all price what a dispatch actually executes.  Call sites
        evaluate this *before* advancing ``t_served``."""
        t_goal = r.timesteps if r.timesteps is not None else self.cfg.timesteps
        t = t_goal - r.t_served
        if self.ecfg.chunk_timesteps is not None:
            t = min(t, self.ecfg.chunk_timesteps)
        return r.workload * (t / self.cfg.timesteps)

    def _t_goal(self, r: Request) -> int:
        """The request's target timestep count (degrade-truncated)."""
        return r.timesteps if r.timesteps is not None else self.cfg.timesteps

    def _next_chunk(self, r: Request) -> int:
        """Length of the request's next chunk (chunked mode)."""
        return min(self.ecfg.chunk_timesteps, self._t_goal(r) - r.t_served)

    def _run_batch(self, frames: Sequence[np.ndarray],
                   timesteps: Optional[int] = None,
                   cache: Optional[ExecCache] = None,
                   bucket: Optional[int] = None):
        """Pad to a bucket, run the forward, copy the outputs to the host.
        ``bucket`` forces a specific pad bucket (canonical-bucket inference);
        the default picks the smallest bucket that fits."""
        cache = cache if cache is not None else self.cache
        if bucket is None:
            bucket = bucket_for(len(frames), self.ecfg.buckets)
        elif bucket < len(frames):
            raise ValueError(
                f"bucket={bucket} cannot hold a batch of {len(frames)}")
        x = pad_frames(frames, bucket)
        return to_host(cache.run(x, self.ecfg.backend, timesteps=timesteps))

    # -- chunked execution (EngineConfig.chunk_timesteps) --------------------
    def _zero_carry_row(self):
        """One all-zero ChunkCarry row (host numpy) — the state a fresh
        request, a pad row, and every warmup batch starts a chunk from."""
        if self._zero_carry is None:
            from repro_torch.core.snn_model import init_chunk_carry
            c1 = to_host(init_chunk_carry(self.cfg, 1, device="cpu"))
            self._zero_carry = _map_carry(lambda a: a[0], c1)
        return self._zero_carry

    def _assemble_carry(self, grp: Sequence[Request], bucket: int):
        """Stack per-request carry rows (zero rows for fresh requests and
        padding) into one batch ChunkCarry with leading axis ``bucket``."""
        zero = self._zero_carry_row()
        rows = [r.carry if r.carry is not None else zero for r in grp]
        rows += [zero] * (bucket - len(grp))
        return ChunkCarry(
            conv_v=tuple(np.stack(xs)
                         for xs in zip(*(r.conv_v for r in rows))),
            dense_v=tuple(np.stack(xs)
                          for xs in zip(*(r.dense_v for r in rows))),
            readout_v=np.stack([r.readout_v for r in rows]))

    def _carry_rows(self, carry, n: int):
        """Split a host batch carry back into ``n`` per-request rows
        (copies, so a row does not pin the whole batch array alive)."""
        return [_map_carry(lambda a: a[j].copy(), carry) for j in range(n)]

    def _exec_chunk(self, grp: Sequence[Request], bucket: int, c: int,
                    cache: Optional[ExecCache] = None):
        """Run one timestep chunk of a micro-batch: pad frames, stack the
        carried membrane state, run ``snn_apply_chunk``, and copy the
        outputs to the host.  Returns ``(ChunkOutputs, host batch carry)``."""
        cache = cache if cache is not None else self.cache
        x = pad_frames([r.frame for r in grp], bucket)
        carry = self._assemble_carry(grp, bucket)
        out, new_carry = cache.run_chunk(x, carry, self.ecfg.backend, c)
        return to_host(out), to_host(new_carry)

    def _finalize_chunked(self, r: Request) -> np.ndarray:
        """A chunk-served request's logits from its carried readout state —
        bit-identical to the whole-T (or degraded-T) forward by the
        chunk-parity contract.  Routed through the cache's finalize entry,
        the whole-T forward's own device op (a host division can round one
        ulp differently)."""
        return self.cache.finalize(r.carry.readout_v, self.ecfg.backend,
                                   self._t_goal(r))

    def _warm_chunk(self, bucket: int, c: int,
                    cache: Optional[ExecCache] = None) -> None:
        """Build + warm the (bucket, chunk length) entry on zero frames and
        zero carry, outside any timed region."""
        cache = cache if cache is not None else self.cache
        h, w = self.cfg.input_hw
        x = np.zeros((bucket, h, w, self.cfg.input_channels), np.float32)
        carry = self._assemble_carry([], bucket)
        _, nc = cache.run_chunk(x, carry, self.ecfg.backend, c)
        to_host(nc.readout_v)

    def _chunk_variants(self) -> List[int]:
        """The chunk lengths this engine can dispatch: the chunk itself and
        the full-T remainder.  Degrade targets are chunk-aligned in
        ``__init__``, so truncated requests introduce no new lengths."""
        ct = self.ecfg.chunk_timesteps
        t_full = self.cfg.timesteps
        lens = {min(ct, t_full)}
        if t_full % ct:
            lens.add(t_full % ct)
        return sorted(lens)

    def _chunk_pad_profile(self, c: int) -> List[np.ndarray]:
        """Per-layer (c, Cout) spike counts of ONE all-zero pad row over one
        chunk of length ``c``.  Exact for every chunk of that length: pad
        rows restart from zero carry each chunk, so their profile is
        independent of the chunk's global timestep offset."""
        key = ("chunk", int(c))
        prof = self._pad_profiles.get(key)
        if prof is None:
            h, w = self.cfg.input_hw
            zero = np.zeros((1, h, w, self.cfg.input_channels), np.float32)
            out, _ = self.cache.run_chunk(
                zero, self._assemble_carry([], 1), self.ecfg.backend, c)
            out = to_host(out)
            prof = [np.asarray(tc, dtype=np.float64)
                    for tc in out.timestep_counts]
            self._pad_profiles[key] = prof
        return prof

    def _accumulate_chunk(self, timestep_counts, n_pad: int, c: int,
                          offset: int) -> None:
        """Fold one chunk micro-batch's (c, Cout) spike counts into the
        running (T, Cout) accumulator at global rows [offset, offset + c),
        subtracting the pad rows' zero-frame chunk profile.  ``offset`` is
        the group's minimum ``t_served`` at dispatch — when a group mixes
        requests at different progress the temporal attribution is
        approximate (counts are batch-summed), but totals stay exact."""
        tcs = [np.asarray(tc, dtype=np.float64) for tc in timestep_counts]
        if n_pad > 0:
            prof = self._chunk_pad_profile(c)
            tcs = [np.maximum(tc - n_pad * p, 0.0)
                   for tc, p in zip(tcs, prof)]
        t_full = self.cfg.timesteps
        offset = max(0, min(int(offset), t_full - c))
        placed = []
        for tc in tcs:
            full = np.zeros((t_full,) + tc.shape[1:], dtype=np.float64)
            full[offset:offset + c] = tc
            placed.append(full)
        if self._tc_accum is None:
            self._tc_accum = placed
        else:
            self._tc_accum = [a + b
                              for a, b in zip(self._tc_accum, placed)]

    def _pad_profile(self, timesteps: Optional[int] = None) -> List[np.ndarray]:
        """Per-layer (T, Cout) spike counts of ONE all-zero pad row.  Exact:
        rows are independent under per-sample convolution, every pad row is
        identical, and spike counts are additive over rows."""
        t = self.cfg.timesteps if timesteps is None else int(timesteps)
        prof = self._pad_profiles.get(t)
        if prof is None:
            h, w = self.cfg.input_hw
            zero = np.zeros((1, h, w, self.cfg.input_channels), np.float32)
            out = to_host(self.cache.run(
                zero, self.ecfg.backend,
                timesteps=None if t == self.cfg.timesteps else t))
            prof = [np.asarray(tc, dtype=np.float64)
                    for tc in out.timestep_counts]
            self._pad_profiles[t] = prof
        return prof

    def _accumulate(self, timestep_counts, n_pad: int,
                    timesteps: Optional[int] = None) -> None:
        """Fold one micro-batch's (T, Cout) spike counts into the running
        actual-workload accumulator, subtracting the ``n_pad`` pad rows'
        zero-frame contribution (nonzero once trained biases fire) and
        zero-extending degraded-T batches to the full T rows."""
        tcs = [np.asarray(tc, dtype=np.float64) for tc in timestep_counts]
        if n_pad > 0:
            prof = self._pad_profile(timesteps)
            tcs = [np.maximum(tc - n_pad * p, 0.0)
                   for tc, p in zip(tcs, prof)]
        t_full = self.cfg.timesteps
        if tcs and tcs[0].shape[0] < t_full:
            tcs = [np.concatenate(
                [tc, np.zeros((t_full - tc.shape[0],) + tc.shape[1:])])
                for tc in tcs]
        if self._tc_accum is None:
            self._tc_accum = tcs
        else:
            self._tc_accum = [a + b for a, b in zip(self._tc_accum, tcs)]

    def accumulated_timestep_counts(self) -> Optional[List[np.ndarray]]:
        """Accumulated per-layer (T, Cout) spike counts over all served
        frames, pad rows masked out (a copy)."""
        if self._tc_accum is None:
            return None
        return [a.copy() for a in self._tc_accum]

    # -- admission ----------------------------------------------------------
    def _fit_delay_model(self) -> Optional[Tuple[float, float]]:
        """Least-squares fit ``svc = quantum + rate * work`` over the
        recorded micro-batch samples; returns (quantum, rate) or None when
        the samples can't identify a positive marginal rate (fewer than two
        distinct workloads)."""
        if len(self._svc_samples) < 2:
            return None
        w = np.asarray([s[0] for s in self._svc_samples], dtype=np.float64)
        t = np.asarray([s[1] for s in self._svc_samples], dtype=np.float64)
        if float(np.ptp(w)) <= 0.0:
            return None
        rate, quantum = np.polyfit(w, t, 1)
        if rate <= 0.0:
            return None
        return (max(float(quantum), 0.0), float(rate))

    def _delay_model(self) -> Optional[Tuple[float, float]]:
        """(per-batch quantum s, marginal seconds-per-work) for the SLO
        delay predictor.  Explicit EngineConfig priors win; otherwise the
        fitted model (the intercept is the fixed dispatch/pad/launch cost a
        micro-batch pays regardless of its work); with too few samples fall
        back to the straggler monitor's mean rate at quantum 0 — the
        historical conservative pricing.  None = no estimate yet
        (admit everything rather than reject blindly)."""
        ecfg = self.ecfg
        quantum = ecfg.slo_batch_quantum_s
        if ecfg.slo_seconds_per_work is not None:
            return (quantum if quantum is not None else 0.0,
                    ecfg.slo_seconds_per_work)
        fit = self._fit_delay_model()
        if fit is not None:
            return (quantum if quantum is not None else fit[0], fit[1])
        spw = self.dispatcher.monitor.seconds_per_work()
        if spw is None:
            return None
        return (quantum if quantum is not None else 0.0, spw)

    def _note_mid_evict(self, r: Request, reason: str, now: float) -> None:
        """A partially chunk-served request left the system at a chunk
        boundary (cancel/deadline): its carried state is dropped.  The
        matching terminal event (cancel/deadline) still fires exactly once —
        ``mid_evict`` is an annotation, not a terminal kind."""
        if r.t_served <= 0:
            return
        self.metrics.mid_evicted += 1
        self.trace.emit(trc.KIND_MID_EVICT, t=now, rid=r.rid, reason=reason,
                        t_served=r.t_served)

    def _mid_flight_degrade(self, in_progress: List[Request], now: float,
                            backlog_work: float) -> List[Request]:
        """SLO degrade applied *mid-flight* (chunked mode): an in-progress
        request predicted to blow its budget has its remaining chunks
        truncated — target ``max(t_served, degrade_t)``, chunk-aligned by
        construction since ``_degrade_t`` is — instead of being rejected
        (it already holds served state).  A request whose truncated target
        is already met completes here from its carried readout, without
        another dispatch.  Returns the requests still needing chunks."""
        ecfg = self.ecfg
        if ecfg.slo_action != "degrade":
            return in_progress
        model = self._delay_model()
        if model is None:
            return in_progress
        quantum, spw = model
        survivors: List[Request] = []
        for r in in_progress:
            budgets = [b for b in (ecfg.latency_budget_s, r.deadline_s)
                       if b is not None]
            t_goal = self._t_goal(r)
            target = max(r.t_served, self._degrade_t)
            if budgets and target < t_goal:
                rem_t = t_goal - r.t_served
                rem_work = r.workload * (rem_t / self.cfg.timesteps)
                # remaining service is rem_t/chunk dispatches, each paying
                # the per-batch quantum (the same per-chunk pricing the
                # admission filter uses — see admission.slo_filter)
                ct = ecfg.chunk_timesteps
                quanta = -(-rem_t // ct) if ct is not None else 1
                predicted = ((now - r.arrival) + quanta * quantum
                             + spw * (rem_work + backlog_work))
                if predicted > min(budgets):
                    r.timesteps = target
                    t_goal = target
                    self.metrics.degraded += 1
                    self.metrics.mid_degraded += 1
                    self.trace.emit(trc.KIND_DEGRADE, t=now, rid=r.rid,
                                    timesteps=target, mid_flight=True)
            if r.t_served >= t_goal:
                # truncated to exactly what has been served: finish now
                r.finish = now
                logits_row = self._finalize_chunked(r)
                if ecfg.keep_logits:
                    r.logits = logits_row
                self.metrics.record_completion(r.arrival, r.finish)
                self._finish_request(r, logits_row)
            else:
                survivors.append(r)
        return survivors

    def _admit_window(self, window: List[Request], num_idle: int, now: float,
                      backlog_work: float = 0.0,
                      ) -> Tuple[List[Tuple[List[Request], Optional[int]]], float]:
        """SLO-filter one FIFO window, then CBWS/batch-aware-bin it into at
        most ``num_idle`` micro-batches.

        Returns ([(group, timesteps_or_None)], predicted balance).  Groups
        are homogeneous in timesteps (degraded requests cannot share an
        executable with full-T ones) and sorted heaviest-first so the caller
        can zip them with the fastest-first lane ranking.  Requests that
        cannot be binned this round (more T-classes than idle lanes, or a
        class over its lane allocation) are pushed back to the FIFO head.
        ``backlog_work`` is predicted work already in flight on busy lanes
        (threaded engine) — it delays everything in this window too.
        """
        t_full = self.cfg.timesteps
        ecfg = self.ecfg
        chunked = ecfg.chunk_timesteps is not None
        # cancelled/expired requests can reach a window when the clock jumps
        # past their fate between sweep and take_window — drop them here so
        # a lane never burns service time on a dead request.  Partially
        # chunk-served requests leave mid-flight: their carried state is
        # discarded at the boundary (KIND_MID_EVICT) and the matching
        # terminal event still fires exactly once.
        live_window: List[Request] = []
        for r in window:
            if r.cancelled:
                self._note_mid_evict(r, "cancelled", now)
                continue
            if r.expired(now):
                self._note_mid_evict(r, "expired", now)
                self._fail_expired([r], now=now)
                continue
            live_window.append(r)
        window = live_window
        # a per-request deadline prices like a personal budget, so the SLO
        # filter runs even on engines with no global latency_budget_s.  In
        # chunked mode only *fresh* requests pass through the filter — an
        # in-progress request already holds served state and is never
        # rejected; instead degrade truncates its remaining chunks below.
        fresh = [r for r in window if r.t_served == 0]
        in_progress = [r for r in window if r.t_served > 0]
        if ecfg.latency_budget_s is not None \
                or any(r.deadline_s is not None for r in fresh):
            model = self._delay_model()
            if model is not None:
                quantum, spw = model
                full_t_rids = {r.rid for r in fresh if r.timesteps is None}
                fresh, rejected, degraded = admission.slo_filter(
                    fresh, now=now, budget_s=ecfg.latency_budget_s,
                    seconds_per_work=spw, batch_quantum_s=quantum,
                    num_lanes=len(self.dispatcher.alive()),
                    full_timesteps=t_full, action=ecfg.slo_action,
                    degrade_timesteps=self._degrade_t,
                    backlog_work=backlog_work,
                    chunk_timesteps=ecfg.chunk_timesteps)
                self.metrics.rejected += len(rejected)
                self.metrics.degraded += degraded
                self.rejected.extend(rejected)
                self._fail_rejected(rejected, now=now)
                for r in fresh:
                    if r.timesteps is not None and r.rid in full_t_rids:
                        self.trace.emit(trc.KIND_DEGRADE, t=now, rid=r.rid,
                                        timesteps=r.timesteps)
        if in_progress:
            in_progress = self._mid_flight_degrade(in_progress, now,
                                                   backlog_work)
        window = sorted(fresh + in_progress,
                        key=lambda r: (r.arrival, r.rid))
        if not window:
            return [], 1.0

        # homogeneous execution classes: whole-T mode bins by the (possibly
        # degraded) timestep count; chunked mode bins by the *next chunk
        # length*, so requests at any progress share a batch as long as
        # their next chunks run the same cache entry
        classes: Dict[int, List[Request]] = {}
        for r in window:
            key = (self._next_chunk(r) if chunked
                   else (r.timesteps if r.timesteps is not None else t_full))
            classes.setdefault(key, []).append(r)
        # FIFO-earliest class first so a 1-lane round serves the queue head
        ordered = sorted(classes.items(),
                         key=lambda kv: min((x.arrival, x.rid)
                                            for x in kv[1]))
        leftovers: List[Request] = []
        if len(ordered) > num_idle:
            for _, reqs in ordered[num_idle:]:
                leftovers += reqs
            ordered = ordered[:num_idle]
        # proportional lane allocation, at least one lane per class
        allocs = [1] * len(ordered)
        lanes_left = num_idle - len(ordered)
        while lanes_left > 0:
            j = max(range(len(ordered)),
                    key=lambda k: len(ordered[k][1]) / allocs[k])
            allocs[j] += 1
            lanes_left -= 1

        dispatchable: List[Tuple[List[Request], Optional[int]]] = []
        for (t_c, reqs), n_c in zip(ordered, allocs):
            cap = ecfg.max_batch * n_c
            if len(reqs) > cap:
                leftovers += reqs[cap:]
                reqs = reqs[:cap]
            groups, _, _ = admission.admit(
                reqs, n_c, ecfg.admission, max_group=ecfg.max_batch,
                buckets=ecfg.buckets if ecfg.batch_aware else None)
            # chunked mode: the class key IS the chunk length the lane will
            # execute; whole-T mode keeps the historical None-for-full-T tag
            dispatchable += [(g, t_c if chunked
                              else (None if t_c == t_full else t_c))
                             for g in groups if g]
        if leftovers:
            self.batcher.push_front(
                sorted(leftovers, key=lambda r: (r.arrival, r.rid)))
        predicted = balance_ratio(
            [sum(self._eff_work(r) for r in g)
             for g, _ in dispatchable] or [1.0])
        dispatchable.sort(
            key=lambda gt: -sum(self._eff_work(r) for r in gt[0]))
        if dispatchable:
            self.trace.emit(
                trc.KIND_ADMIT, t=now, groups=len(dispatchable),
                requests=sum(len(g) for g, _ in dispatchable),
                predicted_balance=predicted)
        return dispatchable, predicted

    # -- event loops --------------------------------------------------------
    def run(self) -> Dict[str, float]:
        """Drain every submitted request; returns the metrics summary.

        ``EngineConfig.threaded`` selects the wall-clock worker-thread
        engine; the default replays deterministically on a virtual clock.
        """
        if self.ecfg.threaded:
            return self._run_threaded()
        return self._run_virtual()

    def _run_virtual(self) -> Dict[str, float]:
        clock = VirtualClock()
        self._clock = clock
        self.trace.bind_clock(clock)
        for r in sorted(self._submitted, key=lambda r: (r.arrival, r.rid)):
            self.batcher.push(r)
        self._submitted = []
        window_idx = 0
        last_failure: Optional[Exception] = None
        # lane -> (predicted eff work, finish time) of its last micro-batch:
        # work still in flight at admission time is backlog the SLO delay
        # model must price (a busy lane delays everything queued behind it)
        busy_work: Dict[int, Tuple[float, float]] = {}
        while len(self.batcher):
            t = clock.now()
            self._sweep_queue(t)
            if not len(self.batcher):
                break
            ready = self.dispatcher.ready(t)
            na = self.batcher.next_arrival()
            arrived = na is not None and na <= t
            if not ready or not arrived:
                nxt = []
                nf = self.dispatcher.next_free(t)
                if nf is not None and arrived:
                    nxt.append(nf)
                if na is not None and na > t:
                    nxt.append(na)
                # a queued deadline can expire before any lane frees — the
                # sweep must run *at* that moment, not at the next unrelated
                # event (the expiry may BE the next event)
                ed = self.batcher.earliest_deadline()
                if ed is not None and ed > t:
                    nxt.append(ed)
                if not nxt:
                    if not self.dispatcher.alive():
                        raise RuntimeError(
                            "all serving lanes failed") from last_failure
                    raise RuntimeError("serving engine stalled")
                clock.advance_to(min(nxt))
                # nudge past an exact-deadline instant so expired() (strict
                # inequality) observes it on the next sweep
                if ed is not None and min(nxt) == ed:
                    clock.advance_to(ed + 1e-9)
                continue

            depth = len(self.batcher)
            window = self.batcher.take_window(t, len(ready))
            self.trace.emit(trc.KIND_WINDOW, t=t, size=len(window),
                            depth=depth)
            backlog = sum(w for w, f in busy_work.values() if f > t)
            dispatchable, predicted = self._admit_window(
                window, len(ready), t, backlog_work=backlog)
            if not dispatchable:
                continue                      # whole window rejected
            # heaviest micro-batch -> measured-fastest lane: CBWS placement
            # re-run over the straggler monitor's latency estimates
            order = self.dispatcher.rank(ready)
            norm_times: Dict[int, float] = {}
            lane_wall: List[float] = []
            executed: List[List[Request]] = []
            group_pred: List[float] = []
            chunk = self.ecfg.chunk_timesteps
            for lane, (grp, tsteps) in zip(order, dispatchable):
                bucket = bucket_for(len(grp), self.ecfg.buckets)
                # dispatch work, priced before t_served advances (chunked
                # mode: exactly the chunk this lane is about to execute)
                work = sum(self._eff_work(r) for r in grp)
                if chunk is not None:
                    # tsteps is the chunk length here (see _admit_window)
                    if not self.cache.has(bucket, self.ecfg.backend,
                                          outputs="chunk", timesteps=tsteps):
                        # build + warm outside the timed region (one-off)
                        self._warm_chunk(bucket, tsteps)

                    def exec_grp(grp=grp, bucket=bucket, c=tsteps):
                        return self._exec_chunk(grp, bucket, c)
                else:
                    if not self.cache.has(bucket, self.ecfg.backend,
                                          timesteps=tsteps):
                        # warm outside the timed region (one-off per bucket)
                        self._run_batch(
                            [grp[0].frame] * min(len(grp), bucket),
                            timesteps=tsteps)

                    def exec_grp(grp=grp, tsteps=tsteps):
                        return self._run_batch([r.frame for r in grp],
                                               timesteps=tsteps)

                def on_retry(attempt, exc, grp=grp, lane=lane, t=t):
                    self.metrics.retries += 1
                    self.trace.emit(trc.KIND_RETRY, t=t, lane=lane,
                                    attempt=attempt)
                    for r in grp:
                        r.retries += 1
                self.trace.emit(trc.KIND_DISPATCH, t=t, lane=lane,
                                n=len(grp),
                                rids=tuple(r.rid for r in grp),
                                timesteps=tsteps)
                if chunk is not None:
                    for r in grp:
                        self.trace.emit(trc.KIND_CHUNK_START, t=t, lane=lane,
                                        rid=r.rid, t0=r.t_served, c=tsteps)
                self.metrics.note_dispatched(len(grp))
                try:
                    out, wall = self.dispatcher.execute(lane, exec_grp,
                                                        on_retry=on_retry)
                except LaneFailed as e:
                    # dead lane: requests keep FIFO priority on survivors —
                    # in chunked mode carry/t_served were last written at a
                    # completed boundary, so the retry resumes from there
                    last_failure = e
                    self.metrics.note_resolved(len(grp))
                    self.trace.emit(trc.KIND_LANE_DEATH, t=t, lane=lane,
                                    error=type(e.cause).__name__)
                    self.batcher.push_front(grp)
                    continue
                if self.ecfg.service_time_fn is None:
                    svc = wall
                elif self._svc_fn_takes_t:
                    svc = self.ecfg.service_time_fn(
                        lane, wall,
                        tsteps if tsteps is not None else self.cfg.timesteps)
                else:
                    svc = self.ecfg.service_time_fn(lane, wall)
                if self._injector is not None:
                    # planned slow lane: scale the committed virtual service
                    # time (the threaded engine sleeps the difference)
                    svc *= self._injector.latency_multiplier(lane)
                finish = self.dispatcher.commit(lane, t, svc, len(grp))
                busy_work[lane] = (work, finish)
                if chunk is not None:
                    cout, new_carry = out
                    self.metrics.chunks_dispatched += len(grp)
                    self._accumulate_chunk(
                        cout.timestep_counts, bucket - len(grp), tsteps,
                        offset=min(r.t_served for r in grp))
                    self._note_skip(cout)
                    self.trace.emit(trc.KIND_BATCH_DONE, t=finish, lane=lane,
                                    n=len(grp), svc=svc)
                    rows = self._carry_rows(new_carry, len(grp))
                    requeue: List[Request] = []
                    for j, r in enumerate(grp):
                        r.carry = rows[j]
                        r.t_served += tsteps
                        r.lane, r.window = lane, window_idx
                        if r.start < 0:
                            r.start = t       # first chunk's dispatch time
                        done = r.t_served >= self._t_goal(r)
                        self.trace.emit(trc.KIND_CHUNK_DONE, t=finish,
                                        lane=lane, rid=r.rid,
                                        t_served=r.t_served, done=done)
                        if done:
                            r.finish = finish
                            logits_row = self._finalize_chunked(r)
                            if self.ecfg.keep_logits:
                                r.logits = logits_row
                            self.metrics.record_completion(r.arrival,
                                                           r.finish)
                            self._finish_request(r, logits_row)
                        else:
                            requeue.append(r)
                    if requeue:
                        # unfinished requests re-enter at the FIFO head with
                        # their updated carry: new arrivals admitted behind
                        # them join the *next* chunk's batch
                        self.batcher.push_front(requeue)
                else:
                    self._accumulate(out.timestep_counts, bucket - len(grp),
                                     tsteps)
                    self._note_skip(out)
                    self.trace.emit(trc.KIND_BATCH_DONE, t=finish, lane=lane,
                                    n=len(grp), svc=svc)
                    logits = np.asarray(out.logits)
                    for j, r in enumerate(grp):
                        r.start, r.finish, r.lane, r.window = (t, finish,
                                                               lane,
                                                               window_idx)
                        if self.ecfg.keep_logits:
                            r.logits = logits[j]
                        self.metrics.record_completion(r.arrival, r.finish)
                        self._finish_request(r, logits[j])
                self.metrics.note_resolved(len(grp))
                if work > 0:
                    norm_times[lane] = svc / work
                    self._svc_samples.append((work, svc))
                lane_wall.append(svc)
                executed.append(grp)
                group_pred.append(work)
            multi = len(executed) >= 2      # 1-lane rounds: balance is vacuous
            self.metrics.record_round(
                queue_depth=depth,
                predicted=predicted if multi else None,
                measured=admission.measured_balance(executed) if multi else None,
                lane_wall=lane_wall,
                group_pred=group_pred if multi else (),
                group_meas=[sum(r.events for r in g)
                            for g in executed] if multi else ())
            self.trace.emit(trc.KIND_ROUND, t=clock.now(),
                            groups=len(executed), window=window_idx)
            self.dispatcher.record_round(norm_times)
            window_idx += 1
        self.trace.emit(trc.KIND_DRAIN, t=clock.now(),
                        served=self.metrics.served)
        return self.summary()

    def _note_skip(self, out) -> None:
        """Fold one micro-batch's kernel skip-table sparsity (mean fraction
        of (t, b, row-block) cells skipped across the fused layers) into the
        metrics; a no-op on backends that don't compute skip tables."""
        fracs = getattr(out, "skip_fractions", ())
        if fracs:
            self.metrics.note_skip_fraction(
                float(np.mean([float(f) for f in fracs])))

    # -- threaded engine ----------------------------------------------------
    def _lane_worker(self, lane: int, cache: ExecCache, clock,
                     inbox: "queue_mod.Queue",
                     completions: "queue_mod.Queue") -> None:
        """One serving lane: pops micro-batches from its inbox, executes them
        (pad + forward + host copy, all off the scheduler thread)
        under the retry budget, and reports over the completion queue.  A
        lane that exhausts its budget reports the failure — its micro-batch
        is never dropped — and exits."""
        while True:
            item = inbox.get()
            if item is None:
                return
            grp, tsteps, widx, t_disp = item
            # heartbeat: picked up work — the supervisor's hang detector
            # measures silence from here (it cannot beat mid-execution, so
            # hang_timeout_s must exceed the worst-case micro-batch)
            self.supervisor.beat(lane, clock.now())
            counts = {"retries": 0}

            def on_retry(attempt, exc, grp=grp):
                counts["retries"] += 1
                self.trace.emit(trc.KIND_RETRY, t=clock.now(), lane=lane,
                                attempt=attempt)
                for r in grp:
                    r.retries += 1

            bucket = bucket_for(len(grp), self.ecfg.buckets)
            chunked = self.ecfg.chunk_timesteps is not None

            if chunked:
                # tsteps is the chunk length; the worker computes the chunk
                # but mutates no request state — carry/t_served advance on
                # the scheduler thread when the completion is handled, so a
                # death/hang mid-chunk resumes from the last boundary
                def exec_grp(grp=grp, bucket=bucket, c=tsteps):
                    return self._exec_chunk(grp, bucket, c, cache=cache)
            else:
                def exec_grp(grp=grp, bucket=bucket, tsteps=tsteps):
                    x = pad_frames([r.frame for r in grp], bucket)
                    return to_host(cache.run(x, self.ecfg.backend,
                                             timesteps=tsteps))

            try:
                out, wall = self.dispatcher.execute(lane, exec_grp,
                                                    on_retry=on_retry)
            except LaneFailed as e:
                completions.put(("failed", lane, grp, e, counts["retries"],
                                 widx))
                return
            except BaseException as e:  # noqa: BLE001 — no request may be lost
                self.dispatcher.mark_dead(lane)
                completions.put(("failed", lane, grp, LaneFailed(lane, e),
                                 counts["retries"], widx))
                return
            if self._injector is not None:
                # planned slow lane: really sleep the extra latency so the
                # wall-clock engine degrades the way the plan says, and
                # report the inflated service time to the delay model
                mult = self._injector.latency_multiplier(lane)
                if mult > 1.0:
                    clock.sleep_until(clock.now() + (mult - 1.0) * wall)
                    wall *= mult
            self.supervisor.beat(lane, clock.now())
            if chunked:
                cout, carry = out
                fracs = getattr(cout, "skip_fractions", ())
                skip = (float(np.mean([float(f) for f in fracs]))
                        if fracs else None)
                completions.put((
                    "done", lane, grp, tsteps, widx, t_disp, clock.now(),
                    None,
                    [np.asarray(tc, dtype=np.float64)
                     for tc in cout.timestep_counts],
                    bucket, wall, counts["retries"], skip, carry))
            else:
                fracs = getattr(out, "skip_fractions", ())
                skip = (float(np.mean([float(f) for f in fracs]))
                        if fracs else None)
                completions.put((
                    "done", lane, grp, tsteps, widx, t_disp, clock.now(),
                    np.asarray(out.logits),
                    [np.asarray(tc, dtype=np.float64)
                     for tc in out.timestep_counts],
                    bucket, wall, counts["retries"], skip, None))

    def _warm_cache(self, cache: ExecCache) -> None:
        """Build + warm every entry a lane can dispatch — each (bucket,
        T-variant) forward, or in chunked mode each (bucket, chunk length)
        chunk entry plus the finalize targets — on ``cache``, which also
        builds the kernels before any lane thread runs.  Runs on the
        scheduler thread only."""
        ecfg = self.ecfg
        cap = bucket_for(ecfg.max_batch, ecfg.buckets)
        warm_sizes = [b for b in ecfg.buckets if b <= cap]
        h, w = self.cfg.input_hw
        zero = np.zeros((h, w, self.cfg.input_channels), np.float32)
        t_variants: List[Optional[int]] = [None]
        if ecfg.latency_budget_s is not None and ecfg.slo_action == "degrade":
            t_variants.append(self._degrade_t)
        if ecfg.chunk_timesteps is not None:
            # chunked dispatch: warm every (bucket, chunk length) chunk
            # entry; whole-T entries are not dispatched, so there is
            # nothing else to warm
            for b in warm_sizes:
                for c in self._chunk_variants():
                    self._warm_chunk(b, c, cache=cache)
            # finalize entries for the common completion targets (a
            # mid-flight truncation to an uncommon t_served builds its
            # finalize lazily — one elementwise op)
            row = self._zero_carry_row().readout_v
            for tv in [self.cfg.timesteps] + (
                    [self._degrade_t] if len(t_variants) > 1 else []):
                cache.finalize(row, ecfg.backend, tv)
        else:
            for b in warm_sizes:
                for tv in t_variants:
                    to_host(cache.run(pad_frames([zero], b), ecfg.backend,
                                      timesteps=tv).logits)

    def _ensure_lane_caches(self) -> List[ExecCache]:
        """Warm every (bucket, T-variant) entry once on the shared cache,
        then fork a private cache per lane (idempotent).  Forks share the
        entries built so far, while any post-fork entry stays lane-private.
        The kernels are built (``kernels._build``) and every entry run once
        here, before the WallClock epoch, so warmup never pollutes latency
        metrics; benchmarks call this via ``warmup()`` to keep build time
        out of their own walls too."""
        if self._lane_caches is not None:
            return self._lane_caches
        ecfg = self.ecfg
        self._warm_cache(self.cache)
        if ecfg.chunk_timesteps is not None:
            for c in self._chunk_variants():
                self._chunk_pad_profile(c)    # pad-mask profiles, pre-clock
        else:
            t_variants: List[Optional[int]] = [None]
            if ecfg.latency_budget_s is not None \
                    and ecfg.slo_action == "degrade":
                t_variants.append(self._degrade_t)
            for tv in t_variants:
                self._pad_profile(tv)
        self._lane_caches = [self.cache.fork()
                             for _ in range(ecfg.num_lanes)]
        return self._lane_caches

    def _run_threaded(self, live: bool = False) -> Dict[str, float]:
        ecfg = self.ecfg
        pending = deque(sorted(self._submitted,
                               key=lambda r: (r.arrival, r.rid)))
        self._submitted = []
        caches = self._ensure_lane_caches()
        if live:
            # serve_forever() built the clock and completion queue *before*
            # starting this scheduler thread, so submit_live() can never
            # race their creation
            clock = self._live_clock
            completions = self._completions
        else:
            clock = WallClock()
            completions = queue_mod.Queue()
        self._clock = clock
        self.trace.bind_clock(clock)
        inboxes = [queue_mod.Queue() for _ in range(ecfg.num_lanes)]
        workers = [threading.Thread(
            target=self._lane_worker,
            args=(i, caches[i], clock, inboxes[i], completions),
            name=f"serving-lane-{i}", daemon=True)
            for i in range(ecfg.num_lanes)]
        for wkr in workers:
            wkr.start()

        busy: set = set()
        inflight_work: Dict[int, float] = {}   # lane -> dispatched eff work
        inflight_items: Dict[int, Tuple] = {}  # lane -> (grp, window idx)
        abandoned: set = set()                 # id(grp) of hang-escalated
        #                                      # dispatches: the zombie's
        #                                      # eventual report is discarded
        window_idx = 0
        restart_gen = [0]
        state: Dict[str, Optional[Exception]] = {"last_failure": None}
        # per-window accounting so round balance is recorded — exactly as in
        # the virtual loop — over the groups that actually *executed*
        # (a group whose lane dies re-enters the queue and must not be
        # double-counted), once the window's last micro-batch resolves
        rounds: Dict[int, Dict] = {}

        def finish_round(widx: int) -> None:
            rs = rounds.pop(widx)
            multi = len(rs["executed"]) >= 2
            self.metrics.record_round(
                queue_depth=rs["depth"],
                predicted=rs["predicted"] if multi else None,
                measured=(admission.measured_balance(rs["executed"])
                          if multi else None),
                lane_wall=rs["lane_wall"],
                group_pred=rs["group_pred"] if multi else (),
                group_meas=[sum(r.events for r in g)
                            for g in rs["executed"]] if multi else ())
            self.trace.emit(trc.KIND_ROUND, t=clock.now(),
                            groups=len(rs["executed"]), window=widx)

        def restart_lane(lane: int) -> None:
            """Supervised recovery: fresh warmed cache fork, fresh inbox,
            new worker thread.  The dead worker already exited (it posts its
            failure and returns), so its inbox is simply abandoned; the
            fork shares every entry the warm shared cache built, so a
            restarted lane serves its first micro-batch warm."""
            restart_gen[0] += 1
            caches[lane] = self.cache.fork()
            inboxes[lane] = queue_mod.Queue()
            wkr = threading.Thread(
                target=self._lane_worker,
                args=(lane, caches[lane], clock, inboxes[lane], completions),
                name=f"serving-lane-{lane}-r{restart_gen[0]}", daemon=True)
            workers[lane] = wkr
            wkr.start()
            t_up = clock.now()
            self.dispatcher.revive(lane, t_up)
            recovery = self.supervisor.on_restarted(lane, t_up)
            self.metrics.record_restart(recovery, t_up)
            self.trace.emit(trc.KIND_LANE_RESTART, t=t_up, lane=lane,
                            recovery_s=recovery)

        def handle(item) -> None:
            if item[0] == "wake":         # live submit()/shutdown() unpark
                return
            kind, lane, grp = item[0], item[1], item[2]
            if id(grp) in abandoned:
                # a presumed-hung zombie finally reported: its micro-batch
                # was already re-queued (and possibly re-served elsewhere) —
                # discard the report wholesale, done or failed, or requests
                # would resolve twice
                abandoned.discard(id(grp))
                return
            busy.discard(lane)
            inflight_work.pop(lane, None)
            inflight_items.pop(lane, None)
            if kind == "failed":
                _, _, grp, exc, retries, widx = item
                state["last_failure"] = exc
                self.metrics.retries += retries
                self.metrics.note_resolved(len(grp))
                self.trace.emit(trc.KIND_LANE_DEATH, t=clock.now(),
                                lane=lane, error=type(exc.cause).__name__)
                # dead lane: requests keep FIFO priority on survivors (or on
                # this lane's supervised replacement), and become cancellable
                # again while they wait
                with self._futures_lock:
                    for r in grp:
                        r.in_flight = False
                self.batcher.push_front(grp)
                self.supervisor.on_death(lane, clock.now())
            else:
                (_, _, grp, tsteps, widx, t_disp, t_done, logits, tcs,
                 bucket, wall, retries, skip, carry) = item
                self.metrics.retries += retries
                self.metrics.note_resolved(len(grp))
                self.dispatcher.commit(lane, t_disp, wall, len(grp))
                # dispatch work, priced before t_served advances below
                work = sum(self._eff_work(r) for r in grp)
                if skip is not None:
                    self.metrics.note_skip_fraction(skip)
                self.trace.emit(trc.KIND_BATCH_DONE, t=t_done, lane=lane,
                                n=len(grp), svc=wall)
                if carry is not None:     # chunked completion (tsteps = c)
                    self.metrics.chunks_dispatched += len(grp)
                    self._accumulate_chunk(
                        tcs, bucket - len(grp), tsteps,
                        offset=min(r.t_served for r in grp))
                    rows = self._carry_rows(carry, len(grp))
                    requeue: List[Request] = []
                    for j, r in enumerate(grp):
                        if r.cancelled:
                            # cancel won the pre-dispatch race by a hair:
                            # the handle already failed with Cancelled —
                            # drop this request's chunk rows
                            self._note_mid_evict(r, "cancelled", t_done)
                            continue
                        r.carry = rows[j]
                        r.t_served += tsteps
                        r.lane, r.window = lane, widx
                        if r.start < 0:
                            r.start = t_disp
                        done = r.t_served >= self._t_goal(r)
                        self.trace.emit(trc.KIND_CHUNK_DONE, t=t_done,
                                        lane=lane, rid=r.rid,
                                        t_served=r.t_served, done=done)
                        if done:
                            r.finish = t_done
                            logits_row = self._finalize_chunked(r)
                            if ecfg.keep_logits:
                                r.logits = logits_row
                            self.metrics.record_completion(r.arrival,
                                                           r.finish)
                            self._finish_request(r, logits_row)
                        else:
                            requeue.append(r)
                    if requeue:
                        # unfinished requests re-enter at the FIFO head with
                        # their updated carry and become cancellable again
                        # while they wait for their next chunk
                        with self._futures_lock:
                            for r in requeue:
                                r.in_flight = False
                        self.batcher.push_front(requeue)
                else:
                    self._accumulate(tcs, bucket - len(grp), tsteps)
                    for j, r in enumerate(grp):
                        r.start, r.finish, r.lane, r.window = (t_disp,
                                                               t_done,
                                                               lane, widx)
                        if r.cancelled:
                            # lost the dispatch race by a hair: the handle
                            # already failed with Cancelled — don't
                            # double-count it as served
                            continue
                        if ecfg.keep_logits:
                            r.logits = logits[j]
                        self.metrics.record_completion(r.arrival, r.finish)
                        self._finish_request(r, logits[j])
                if work > 0:
                    self.dispatcher.record_round({lane: wall / work})
                    self._svc_samples.append((work, wall))
                rounds[widx]["executed"].append(grp)
                rounds[widx]["lane_wall"].append(wall)
                rounds[widx]["group_pred"].append(work)
            rounds[widx]["pending"] -= 1
            if rounds[widx]["pending"] == 0:
                finish_round(widx)

        try:
            while True:
                live_running = live and not self._stop.is_set()
                if not (pending or len(self.batcher) or busy
                        or live_running):
                    break
                now = clock.now()
                while pending and pending[0].arrival <= now:
                    self.batcher.push(pending.popleft())
                while True:                      # drain completions
                    try:
                        handle(completions.get_nowait())
                    except queue_mod.Empty:
                        break
                now = clock.now()
                self._sweep_queue(now)
                # supervised recovery: bring restart-due lanes back before
                # forming a window, so they take traffic this iteration
                for lane in self.supervisor.due_restarts(now):
                    restart_lane(lane)
                # hang escalation: a busy lane silent past hang_timeout_s is
                # presumed stuck — re-queue its micro-batch and treat the
                # lane as dead (Python cannot kill the thread; its eventual
                # report is discarded via the abandoned set)
                for lane in self.supervisor.stale(now, list(busy)):
                    if lane not in busy:
                        continue
                    self.dispatcher.mark_dead(lane)
                    grp, widx = inflight_items.pop(lane)
                    abandoned.add(id(grp))
                    busy.discard(lane)
                    inflight_work.pop(lane, None)
                    self.metrics.note_resolved(len(grp))
                    self.trace.emit(trc.KIND_HANG, t=now, lane=lane,
                                    n=len(grp))
                    state["last_failure"] = RuntimeError(
                        f"lane {lane} presumed hung: no heartbeat in "
                        f"{self.supervisor.hang_timeout_s}s")
                    with self._futures_lock:
                        for r in grp:
                            r.in_flight = False
                    self.batcher.push_front(grp)
                    self.supervisor.on_death(lane, now)
                    rounds[widx]["pending"] -= 1
                    if rounds[widx]["pending"] == 0:
                        finish_round(widx)
                alive = self.dispatcher.alive()
                if not alive and not self.supervisor.pending_restarts():
                    # drain the final failure completion (the worker marks
                    # its lane dead *before* posting, so the item carrying
                    # the micro-batch + cause may still be in transit)
                    while busy:
                        try:
                            handle(completions.get(timeout=1.0))
                        except queue_mod.Empty:
                            break
                    raise RuntimeError(
                        "all serving lanes failed") from state["last_failure"]
                idle = [l for l in alive if l not in busy]
                na = self.batcher.next_arrival()
                if idle and na is not None and na <= now:
                    depth = len(self.batcher)
                    window = self.batcher.take_window(now, len(idle))
                    self.trace.emit(trc.KIND_WINDOW, t=now,
                                    size=len(window), depth=depth)
                    dispatchable, predicted = self._admit_window(
                        window, len(idle), now,
                        backlog_work=sum(inflight_work.values()))
                    if dispatchable:
                        order = self.dispatcher.rank(idle)
                        rounds[window_idx] = {
                            "depth": depth, "predicted": predicted,
                            "pending": len(dispatchable), "executed": [],
                            "lane_wall": [], "group_pred": []}
                        for lane, (grp, tsteps) in zip(order, dispatchable):
                            busy.add(lane)
                            inflight_work[lane] = sum(self._eff_work(r)
                                                      for r in grp)
                            inflight_items[lane] = (grp, window_idx)
                            # cancel barrier: from here the dispatch owns
                            # these requests — cancel() refuses
                            with self._futures_lock:
                                for r in grp:
                                    r.in_flight = True
                            t_disp = clock.now()
                            self.trace.emit(
                                trc.KIND_DISPATCH, t=t_disp, lane=lane,
                                n=len(grp),
                                rids=tuple(r.rid for r in grp),
                                timesteps=tsteps,
                                device=(self._lane_device_strs[lane]
                                        if self._lane_device_strs else None))
                            if ecfg.chunk_timesteps is not None:
                                for r in grp:
                                    self.trace.emit(
                                        trc.KIND_CHUNK_START, t=t_disp,
                                        lane=lane, rid=r.rid,
                                        t0=r.t_served, c=tsteps)
                            self.metrics.note_dispatched(len(grp))
                            inboxes[lane].put(
                                (grp, tsteps, window_idx, t_disp))
                        window_idx += 1
                    continue
                # nothing dispatchable: park until the next timed event — a
                # replayed arrival, a queued deadline expiring, an owed lane
                # restart, or a hang-detection check — interruptibly
                # whenever completions/wake sentinels can land, so neither
                # expiry nor recovery waits on an unrelated event
                bounds = []
                if pending:
                    bounds.append(pending[0].arrival)
                ed = self.batcher.earliest_deadline()
                if ed is not None:
                    bounds.append(ed)
                ra = self.supervisor.next_restart_at()
                if ra is not None:
                    bounds.append(ra)
                if busy and self.supervisor.hang_timeout_s is not None:
                    bounds.append(now + self.supervisor.hang_timeout_s)
                if busy or live_running or ra is not None or ed is not None:
                    timeout = (max(0.0, min(bounds) - clock.now())
                               if bounds else (0.5 if live_running else None))
                    try:
                        handle(completions.get(timeout=timeout))
                    except queue_mod.Empty:
                        pass
                elif pending:
                    clock.sleep_until(pending[0].arrival)
                elif len(self.batcher):
                    continue        # re-queued failures: loop re-dispatches
                else:
                    break
        finally:
            for ib in inboxes:
                ib.put(None)
            for wkr in workers:
                wkr.join(timeout=5.0)
            self._lane_compiles = sum(c.compiles for c in caches)
            self.trace.emit(trc.KIND_DRAIN, t=clock.now(),
                            served=self.metrics.served)
        return self.summary()

    # -- live serving (serve_forever) ---------------------------------------
    def serve_forever(self) -> "ServingEngine":
        """Start live serving: the threaded scheduler runs in the background
        and ``submit_live()`` is accepted *while it runs* (the batcher and
        dispatcher already lock).  Returns immediately; every build
        happens here, before the live clock epoch, so first-request latency
        is a serve, not a trace.

        Pre-``submit()``-ed requests (if any) replay their arrival offsets
        against the live epoch.  Call ``shutdown()`` to stop: it refuses new
        submissions, drains the queue and all in-flight micro-batches, and
        returns the metrics summary.
        """
        if not self.ecfg.threaded:
            raise ValueError(
                "serve_forever() requires EngineConfig.threaded=True — live "
                "submission runs on worker-thread lanes; the virtual clock "
                "replays pre-submitted traces only (use run())")
        if self._live_thread is not None:
            raise RuntimeError("serve_forever() is already running")
        self._ensure_lane_caches()        # all compilation before the epoch
        self._stop = threading.Event()
        # no scheduler thread exists yet, so nothing races this reset
        self._live_error = None  # lint: allow(lock-discipline)
        self._live_summary = None
        self._completions = queue_mod.Queue()
        self._live_clock = WallClock()

        def _scheduler():
            try:
                self._live_summary = self._run_threaded(live=True)
            except BaseException as e:  # noqa: BLE001 — surfaced by shutdown
                # close submissions BEFORE failing outstanding handles, under
                # the submit lock: a racing submit_live() either registered
                # its handle first (it gets failed here) or observes the
                # stop/error and raises — no handle can slip in after the
                # sweep and hang its client forever
                with self._submit_lock:
                    self._live_error = e
                    self._stop.set()
                self._fail_outstanding(e)

        self._live_thread = threading.Thread(
            target=_scheduler, name="serving-scheduler", daemon=True)
        self._live_thread.start()
        return self

    @property
    def live(self) -> bool:
        """True while serve_forever() is accepting submissions."""
        # advisory snapshot: the error write is sticky (None -> exc once),
        # so a lock-free read can only be momentarily stale, never wrong
        return (self._live_thread is not None and self._stop is not None
                and not self._stop.is_set()
                and self._live_error is None)  # lint: allow(lock-discipline)

    def shutdown(self, timeout: Optional[float] = None) -> Dict[str, float]:
        """Stop a live engine cleanly: no new submissions, every queued
        request and in-flight micro-batch drains (futures resolve), the
        scheduler and lane workers join.  Returns the metrics summary;
        re-raises the engine failure if serving died (after failing every
        outstanding handle, so no client hangs).

        If the scheduler cannot drain within ``timeout``, every outstanding
        handle fails with ``ShutdownTimeout`` *before* this raises — a
        client blocked in ``result()`` learns its fate instead of hanging
        forever.  Should the wedged scheduler later limp through a stray
        completion, the resolution is a no-op (its handle was already
        popped), so the exactly-once guarantee survives the timeout path
        too."""
        if self._live_thread is None:
            raise RuntimeError("engine is not live (serve_forever not running)")
        with self._submit_lock:
            self._stop.set()
        self.trace.emit(trc.KIND_SHUTDOWN, t=self._live_clock.now())
        self._completions.put(("wake",))
        self._live_thread.join(timeout)
        still_running = self._live_thread.is_alive()
        if still_running:
            exc = ShutdownTimeout(
                f"live scheduler did not drain within {timeout}s")
            self._fail_outstanding(exc)
            raise exc
        self._live_thread = None
        # the scheduler thread has joined: its error write happened-before
        # this read, no lock needed
        if self._live_error is not None:  # lint: allow(lock-discipline)
            raise self._live_error
        return self._live_summary

    # -- single-shot / throughput modes ------------------------------------
    def warmup(self, sizes: Optional[Sequence[int]] = None) -> None:
        """Compile + warm the bucket executables outside any timed region
        (benchmarks call this before starting their clocks).  For the
        threaded engine this also builds every lane's private cache."""
        if self.ecfg.threaded:
            self._ensure_lane_caches()
            return
        h, w = self.cfg.input_hw
        zero = np.zeros((h, w, self.cfg.input_channels), np.float32)
        # include the bucket that max_batch-sized groups pad into
        cap = bucket_for(self.ecfg.max_batch, self.ecfg.buckets)
        for b in sizes or [s for s in self.ecfg.buckets if s <= cap]:
            if not self.cache.has(b, self.ecfg.backend):
                self._run_batch([zero] * b)

    def infer(self, frames: np.ndarray, bucket: Optional[int] = None):
        """One batch through the bucketed exec cache; padded rows sliced
        off.  Returns the SNNOutputs on the host.

        ``bucket`` pins the pad bucket instead of the smallest fit — the
        *canonical-bucket* option.  A row's logits do not depend on its
        batchmates or the bucket (``core.snn_layers``), so every bucket
        gives the same bits."""
        frames = np.asarray(frames, dtype=np.float32)
        n = frames.shape[0]
        if bucket is not None:
            bucket = int(bucket)
            if bucket not in self.ecfg.buckets:
                raise ValueError(
                    f"bucket={bucket} is not one of the engine's padding "
                    f"buckets {tuple(self.ecfg.buckets)}")
            if bucket < n:
                raise ValueError(
                    f"bucket={bucket} cannot hold a batch of {n}")
        out = self._run_batch(list(frames), bucket=bucket)
        return out._replace(logits=out.logits[:n])

    def infer_pipelined(self, frames: np.ndarray, steps: int) -> float:
        """Serve ``steps`` batches back-to-back; returns wall seconds.

        The engine's throughput mode: a logits-only entry, launched
        ``steps`` times with no per-batch host sync and one synchronize at
        the end, so the host's launches overlap the device's work."""
        frames = np.asarray(frames, dtype=np.float32)
        bucket = bucket_for(frames.shape[0], self.ecfg.buckets)
        x = to_device(pad_frames(list(frames), bucket), self.device)
        fn = self.cache.get(bucket, self.ecfg.backend, outputs="logits")
        to_host(fn(self.params, x))       # builds the kernels, warms
        stopwatch = WallClock()           # epoch after warmup: pure serving
        for _ in range(steps):
            fn(self.params, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return stopwatch.now()

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> MetricsSnapshot:
        """A consistent point-in-time view of the engine, callable from any
        thread *while* ``serve_forever()`` (or ``run()``) is mid-burst.

        Each source is read under its own lock — metrics counters and
        rolling percentiles (``ServingMetrics.snapshot_fields``), queue
        depth (batcher), lane health (dispatcher + straggler monitor),
        restart budget state (supervisor) — so the snapshot never tears a
        single subsystem's state; ``LiveServer.metrics()`` is the public
        route here."""
        m = self.metrics.snapshot_fields()
        lane_stats = self.dispatcher.lane_stats()
        sup = self.supervisor.stats()
        if self._live_clock is not None:
            ts = self._live_clock.now()
        elif self.trace._clock is not None:
            ts = self.trace._clock.now()
        else:
            ts = 0.0
        return MetricsSnapshot(
            ts=float(ts),
            live=self.live,
            served=int(m["served"]),
            queued=len(self.batcher),
            in_flight=int(m["in_flight"]),
            rejected=int(m["rejected"]),
            degraded=int(m["degraded"]),
            deadline_missed=int(m["deadline_missed"]),
            cancelled=int(m["cancelled"]),
            queue_full=int(m["queue_full"]),
            rounds=int(m["rounds"]),
            retries=int(m["retries"]),
            queue_watermark=int(m["queue_watermark"]),
            p50_latency_s=float(m["p50_latency_s"]),
            p99_latency_s=float(m["p99_latency_s"]),
            fps=float(m["fps"]),
            wall_s=float(m["wall_s"]),
            predicted_balance=float(m["predicted_balance"]),
            measured_balance=float(m["measured_balance"]),
            workload_residual=float(m["workload_residual"]),
            residual_rounds=int(m["residual_rounds"]),
            skip_sparsity=float(m["skip_sparsity"]),
            skip_batches=int(m["skip_batches"]),
            lanes_alive=sum(1 for l in lane_stats if l["alive"]),
            lanes_total=len(lane_stats),
            lane_seconds_per_work=tuple(
                self.dispatcher.monitor.per_host_seconds_per_work()),
            lane_served=tuple(int(l["served"]) for l in lane_stats),
            restarts=int(sup["restarts"]),
            restart_budget=self.ecfg.restart_budget,
            per_lane_restarts=tuple(sup["per_lane_restarts"]),
            permanently_dead=tuple(sup["permanently_dead"]),
            pending_restarts=tuple(sup["pending_restarts"]),
            trace_enabled=self.trace.enabled,
            trace_events=len(self.trace),
            trace_dropped=self.trace.dropped,
            chunk_timesteps=self.ecfg.chunk_timesteps,
            chunks_dispatched=int(m["chunks_dispatched"]),
            mid_evicted=int(m["mid_evicted"]),
            mid_degraded=int(m["mid_degraded"]),
            lane_devices=self._lane_device_strs,
        )

    def summary(self) -> Dict[str, float]:
        s = self.metrics.summary()
        s["compiles"] = self.cache.compiles + self._lane_compiles
        s["dead_lanes"] = len(self.dispatcher.lanes) - len(self.dispatcher.alive())
        s["permanently_dead_lanes"] = float(
            len(self.supervisor.permanently_dead()))
        if self._tc_accum is not None and self.metrics.served:
            s.update(energy_per_image(self.cfg, self.params, self._tc_accum,
                                      self.metrics.served))
        return s

