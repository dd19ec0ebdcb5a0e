"""Workload-balanced SNN serving engine (continuous batching): the port of
``repro.serving``.

The paper's balance math lifted one level up: frame *requests* arriving with
different predicted spike workloads are the channels, replica/micro-batch
lanes are the SPEs, and Algorithm 1 (``core.cbws``) bins each admission
window into workload-balanced micro-batches.

  request     Request record (frame, arrival, predicted/actual workload)
  clock       the event loop's clock: VirtualClock (deterministic replay)
              vs WallClock (live threaded serving)
  batcher     thread-safe FIFO + padding-bucketed dynamic batching + exec
              cache
  admission   APRC-predicted request workloads -> CBWS lane binning
              (batch-aware bucket planning) + SLO reject/degrade control
  dispatch    lane execution, straggler monitoring, failure/retry
  metrics     p50/p99 latency, FPS, queue depth, balance, energy/image
  engine      the continuous-batching loop (virtual or worker-thread lanes)
              + single-shot mode
"""
from repro_torch.serving.admission import (admit, bucket_size_plan,
                                           predict_workload, slo_filter)
from repro_torch.serving.batcher import (DEFAULT_BUCKETS, DynamicBatcher,
                                         ExecCache, bucket_for)
from repro_torch.serving.clock import Clock, VirtualClock, WallClock
from repro_torch.serving.dispatch import LaneDispatcher, LaneFailed
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.futures import (Cancelled, DeadlineExceeded,
                                         QueueFull, RequestHandle,
                                         ShutdownTimeout, SLORejected)
from repro_torch.serving.metrics import ServingMetrics, energy_per_image
from repro_torch.serving.request import Request
from repro_torch.serving.supervisor import LaneSupervisor

__all__ = [
    "admit", "bucket_size_plan", "predict_workload", "slo_filter",
    "DEFAULT_BUCKETS", "DynamicBatcher", "ExecCache", "bucket_for",
    "Clock", "VirtualClock", "WallClock",
    "LaneDispatcher", "LaneFailed", "LaneSupervisor",
    "EngineConfig", "ServingEngine",
    "RequestHandle", "SLORejected", "DeadlineExceeded", "Cancelled",
    "QueueFull", "ShutdownTimeout",
    "ServingMetrics", "energy_per_image",
    "Request",
]
