"""``Session``: one object that owns params, resolves a spec once, and
caches the serving engines behind the facade's verbs (the reference's
``repro.api.session``).

    sess = Session("snn-mnist", TrainSpec(backend="hopper", lr=1e-2))
    for x, y in batches:
        loss = sess.train_step(x, y)
    acc = sess.evaluate(xte, yte)
    out = sess.infer(frames)                     # bucketed exec cache
    stats = sess.serve(frames, steps=8)          # single-shot timing
    with sess.serve_forever() as live:           # threaded live engine
        handles = [live.submit(f) for f in frames]
        logits = [h.result(timeout=30) for h in handles]

The spec is resolved once, here: names were validated when the spec was
built, the kernel-level CBWS schedule (``hopper``) is built by the engine
layer from the resolved mode, and every entry point hands frames to a
Session instead of threading ``backend=``/``surrogate_*`` through the
layers.  A session runs on ``device`` (default: the card); frames and
labels may be numpy arrays or tensors, and outputs of ``infer``/``serve``
come back on the host, as numpy arrays.  A spec with a ``mesh`` runs
``infer``, ``train_step`` and ``evaluate`` through a ``dist.MeshRunner``
and pins the engines' lanes to the mesh's entries; the mesh's devices are
of the session's kind (the cards ``cuda:0..N-1``, or N host entries on
the CPU).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import obs
from repro_torch.api.specs import ExecutionSpec, ServeSpec, TrainSpec
from repro_torch.config import SNNConfig, get_snn
from repro_torch.device import resolve_device
from repro_torch.serving.batcher import to_device

__all__ = ["Session", "LiveServer"]


class Session:
    """Owns params and the serving engines for one Skydiver model under
    one spec.

    ``model`` is a registry name (``"snn-mnist"``) or an ``SNNConfig``;
    ``spec`` is any ``ExecutionSpec`` (a ``TrainSpec`` sets the optimizer
    of ``train_step``, a ``ServeSpec`` configures ``engine()`` and
    ``serve_forever()``; the other verbs derive sub-specs from the
    execution fields).  ``params=None`` draws fresh weights from ``seed``
    (``init_snn`` on ``torch.Generator().manual_seed(seed)``); given
    params (an ``init_snn`` or ``interop.from_jax_params`` dict) are moved
    to ``device``.
    """

    def __init__(self, model: Union[str, SNNConfig],
                 spec: Optional[ExecutionSpec] = None, *,
                 params: Optional[Dict] = None, seed: int = 0,
                 device=None):
        from repro_torch.core.snn_model import init_snn
        self.spec = spec if spec is not None else ExecutionSpec()
        if not isinstance(self.spec, ExecutionSpec):
            raise TypeError(
                f"spec must be an ExecutionSpec/TrainSpec/ServeSpec, "
                f"got {type(self.spec).__name__}")
        cfg = get_snn(model) if isinstance(model, str) else model
        if self.spec.timesteps is not None:
            cfg = dataclasses.replace(cfg, timesteps=self.spec.timesteps)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = (to_device(params, self.device) if params is not None
                       else init_snn(torch.Generator().manual_seed(seed), cfg,
                                     device=self.device))
        self._engines: Dict[int, object] = {}    # batch size -> single-shot
        self._train_step = None
        self._mom = None
        self._device_mesh = None                 # dist.DeviceMesh
        self._mesh_runner = None                 # dist.MeshRunner

    # -- mesh plumbing -------------------------------------------------------
    def _device_mesh_for(self, mesh_axes):
        """Resolve a mesh description to a ``DeviceMesh`` of the session's
        device kind (cached for the session's own spec; an override
        ServeSpec with another mesh gets a fresh resolution)."""
        if self._device_mesh is not None \
                and self._device_mesh.axes == mesh_axes:
            return self._device_mesh
        from repro_torch.dist import DeviceMesh
        dm = DeviceMesh(mesh_axes, device=self.device.type)
        if self._device_mesh is None:
            self._device_mesh = dm
        return dm

    def _runner(self):
        """The session's ``MeshRunner`` (None when the spec has no mesh),
        which infer, train_step and evaluate route through."""
        if self.spec.mesh is None:
            return None
        if self._mesh_runner is None:
            from repro_torch.dist import MeshRunner
            self._mesh_runner = MeshRunner(
                self._device_mesh_for(self.spec.mesh), self.cfg, self.spec)
        return self._mesh_runner

    def _lane_devices(self, spec: ServeSpec, num_lanes: int,
                      overrides: Dict) -> Dict:
        """``overrides`` with the mesh's lane pinning added, when ``spec``
        has a mesh and the caller pinned nothing."""
        if spec.mesh is not None and "lane_devices" not in overrides:
            overrides = {**overrides, "lane_devices": self._device_mesh_for(
                spec.mesh).lane_devices(num_lanes)}
        return overrides

    # -- spec plumbing -------------------------------------------------------
    def _as_serve_spec(self, spec: Optional[ServeSpec] = None) -> ServeSpec:
        """The ServeSpec governing engine construction: an explicit override
        wins, then the session's own spec if it is one, else a default
        ServeSpec carrying the session's execution fields."""
        if spec is not None:
            if spec.timesteps is not None \
                    and spec.timesteps != self.cfg.timesteps:
                raise ValueError(
                    f"override ServeSpec.timesteps={spec.timesteps} "
                    f"conflicts with the session's T={self.cfg.timesteps} "
                    f"(timesteps are resolved once, at Session construction)")
            return spec
        if isinstance(self.spec, ServeSpec):
            return self.spec
        return ServeSpec(**self.spec.execution_fields())

    def _as_train_spec(self) -> TrainSpec:
        if isinstance(self.spec, TrainSpec):
            return self.spec
        # the kernel schedule is serving-only (a deployment-time weight
        # permutation TrainSpec rejects): train without it, as evaluate
        # does, and whole T
        return TrainSpec(**{**self.spec.execution_fields(),
                            "schedule_mode": None, "chunk_timesteps": None})

    def _engine_config(self, spec: ServeSpec, **overrides):
        return spec.to_engine_config(device=str(self.device), **overrides)

    # -- inference / serving -------------------------------------------------
    def _single_shot_engine(self, batch: int):
        """One cached 1-lane engine per batch size (its bucket set is
        extended so that any batch has a bucket)."""
        eng = self._engines.get(batch)
        if eng is None:
            from repro_torch.serving.batcher import DEFAULT_BUCKETS, bucket_for
            from repro_torch.serving.engine import ServingEngine
            spec = self._as_serve_spec()
            buckets = (spec.buckets if spec.buckets is not None
                       else DEFAULT_BUCKETS)
            if batch > max(buckets):
                buckets = tuple(buckets) + (int(batch),)
            ecfg = self._engine_config(spec, **self._lane_devices(
                spec, 1, dict(num_lanes=1, threaded=False,
                              buckets=tuple(buckets),
                              max_batch=bucket_for(batch, buckets))))
            eng = ServingEngine(self.params, self.cfg, ecfg)
            self._engines[batch] = eng
        return eng

    def infer(self, frames, *, bucket: Optional[int] = None):
        """One batch through the engine's exec cache; returns ``SNNOutputs``
        on the host (padded rows sliced off).  Bit-identical to what
        ``serve`` and ``serve_forever`` give for the same frames: a row's
        logits depend neither on its batchmates nor on the bucket.
        ``bucket`` pins the padding bucket instead of the smallest fit.

        With a mesh in the spec, the batch is sharded over the mesh's batch
        axes by the session's ``MeshRunner`` (``bucket`` is its pad target):
        the logits equal the unsharded ones bit for bit.

        Under a profiler, the call is the root span ``repro_torch.infer``
        and its stages (``infer.stage``, ``infer.forward``, ``infer.wait``,
        ``infer.readback``) are spans inside it (``obs.spans``)."""
        with obs.span("infer", root=True):
            with obs.span("infer.stage"):
                frames = np.asarray(frames, dtype=np.float32)
            n = frames.shape[0]
            if bucket is not None and bucket < n:
                raise ValueError(
                    f"bucket={bucket} cannot hold a batch of {n}")
            runner = self._runner()
            if runner is not None:
                return runner.infer(self.params, frames, pad_to=bucket)
            eng = self._single_shot_engine(n if bucket is None
                                           else max(n, int(bucket)))
            return eng.infer(frames, bucket=bucket)

    def serve(self, frames, *, steps: int = 1) -> Dict[str, float]:
        """Single-shot serving: ``steps`` iterations of one fixed batch, each
        done when its outputs are on the host (the synchronous loop);
        returns timing and spike stats."""
        frames = np.asarray(frames, dtype=np.float32)
        eng = self._single_shot_engine(frames.shape[0])
        out = eng.infer(frames)                       # builds and warms
        t0 = time.perf_counter()
        for _ in range(steps):
            out = eng.infer(frames)
        dt = time.perf_counter() - t0
        done = steps * frames.shape[0]
        return {
            "frames": done,
            "seconds": dt,
            "fps": done / dt if dt > 0 else 0.0,
            "spikes_per_frame": sum(float(t) for t in out.spike_totals)
            / frames.shape[0],
            "outputs": out,
        }

    def engine(self, spec: Optional[ServeSpec] = None, **hooks):
        """A fresh continuous-batching ``ServingEngine`` for trace replay
        (``submit`` + ``run``).  ``hooks`` passes the engine's own test
        knobs (``fault_hook``, ``service_time_fn``) through untyped.  With
        a mesh, lane i is pinned to the mesh's entry ``i % N``."""
        from repro_torch.serving.engine import ServingEngine
        sspec = self._as_serve_spec(spec)
        return ServingEngine(self.params, self.cfg, self._engine_config(
            sspec, **self._lane_devices(sspec, sspec.num_lanes, hooks)))

    def serve_forever(self, spec: Optional[ServeSpec] = None
                      ) -> "LiveServer":
        """Start a live threaded engine that accepts submissions while it
        runs.  Returns a ``LiveServer`` (also a context manager):
        ``submit(frame)`` gives a future-style handle, ``shutdown()`` drains
        and returns the metrics summary.  ``threaded`` is forced on."""
        sspec = self._as_serve_spec(spec)
        if not sspec.threaded:
            sspec = dataclasses.replace(sspec, threaded=True)
        from repro_torch.serving.engine import ServingEngine
        eng = ServingEngine(self.params, self.cfg, self._engine_config(
            sspec, **self._lane_devices(sspec, sspec.num_lanes, {})))
        return LiveServer(eng.serve_forever())

    # -- training ------------------------------------------------------------
    def train_step(self, x, y) -> float:
        """One surrogate-gradient SGD step with momentum on the session's
        params (spec-selected backend); returns the loss.  The step function
        is built once; params and momentum live on the session, and the
        cached engines serve the new params from the next call on.

        With a mesh, the step runs through the session's ``MeshRunner``:
        per-example gradient rows, combined on the host in a fixed order,
        so the new params are bit-identical at every shard count.

        Under a profiler, the step is the root span
        ``repro_torch.train_step``, with ``train.stage``, ``train.forward``,
        ``train.backward`` (the weight gradient, ``train.wgrad``, inside
        it), ``train.update`` and ``train.wait`` (``obs.spans``)."""
        from repro_torch.core.snn_train import make_train_step
        with obs.span("train_step", root=True):
            if self._mom is None:
                self._mom = tree_map(torch.zeros_like, self.params)
            runner = self._runner()
            if runner is not None:
                self.params, self._mom, loss = runner.train_step(
                    self.params, self._mom, x, y)
            else:
                if self._train_step is None:
                    self._train_step = make_train_step(
                        self.cfg, spec=self._as_train_spec())
                with obs.span("train.stage"):
                    x, y = to_device((x, y), self.device)
                self.params, self._mom, loss = self._train_step(
                    self.params, self._mom, x, y)
            with obs.span("train.update"):
                for eng in self._engines.values():
                    eng.update_params(self.params)
            with obs.span("train.wait"):
                return float(loss)

    def evaluate(self, x, y) -> float:
        """Classification accuracy through the spec-selected backend, on
        canonical weights (the kernel schedule, a serving-time weight
        permutation, is stripped, as for training); with a mesh, sharded
        by the session's ``MeshRunner``."""
        from repro_torch.core.snn_model import snn_apply
        runner = self._runner()
        if runner is not None:
            logits = runner.infer(self.params, x, logits_only=True).logits
            y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
            return float((logits.argmax(-1) == np.asarray(y)).mean())
        spec = ExecutionSpec(**{**self.spec.execution_fields(),
                                "schedule_mode": None})
        x, y = to_device((x, y), self.device)
        with torch.no_grad():
            logits = snn_apply(self.params, x, self.cfg, spec=spec,
                               logits_only=True).logits
            return float((logits.argmax(dim=-1) == y.long()).float().mean())


class LiveServer:
    """Client handle of a live (``serve_forever``) engine; as a context
    manager it shuts down (draining every queued and in-flight request) on
    exit."""

    def __init__(self, engine):
        self._engine = engine
        self._summary: Optional[Dict[str, float]] = None

    def submit(self, frame, deadline_s: Optional[float] = None):
        """Submit one frame; returns a ``RequestHandle`` future
        (``result(timeout)``, ``done()``, ``exception()``, ``cancel()``).
        ``deadline_s`` is the request's latency contract (seconds after
        arrival; default the spec's ``default_deadline_s``).  Raises
        ``QueueFull`` at once when the spec's ``max_queue`` is reached."""
        return self._engine.submit_live(np.asarray(frame, dtype=np.float32),
                                        deadline_s=deadline_s)

    @property
    def running(self) -> bool:
        return self._engine.live

    def metrics(self):
        """A consistent ``obs.MetricsSnapshot`` of the running engine,
        callable from any thread while requests are in flight."""
        return self._engine.snapshot()

    def trace(self):
        """The engine's ``obs.TraceRecorder`` (empty unless the spec set
        ``trace=True``)."""
        return self._engine.trace

    def shutdown(self, timeout: Optional[float] = None) -> Dict[str, float]:
        """Drain and stop; returns (and caches) the metrics summary."""
        if self._summary is None:
            self._summary = self._engine.shutdown(timeout)
        return self._summary

    def summary(self) -> Dict[str, float]:
        if self._summary is None:
            raise RuntimeError("live server still running — shutdown() first")
        return self._summary

    @property
    def engine(self):
        """The underlying ServingEngine (metrics, completed requests)."""
        return self._engine

    def __enter__(self) -> "LiveServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # on an exception path still drain, but do not mask the original
        # error with a shutdown re-raise
        try:
            self.shutdown()
        except Exception:
            if exc_type is None:
                raise
