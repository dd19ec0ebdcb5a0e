"""APRC-predicted admission: request workloads -> CBWS micro-batch binning,
plus admission-time SLO control.

Request-level reuse of the paper's pipeline.  Per layer the paper predicts
each *channel's* workload from filter magnitudes and partitions channels
across SPEs with Algorithm 1; here each *request's* workload is predicted
from its input spike density weighted by the layer-0 APRC channel
predictions, and Algorithm 1 (``cbws_partition``) partitions the admission
window across K serving lanes.  FIFO striping (``naive_partition`` over
arrival order) is the no-schedule baseline, exactly mirroring Fig. 7's
'Neither' bar.

Three serving-specific refinements on top of plain Algorithm 1:

* **Never-worse guarantee** — ``admit(policy="cbws")`` also evaluates the
  FIFO stripe of the same window and returns whichever partition *predicts*
  the better balance.  Algorithm 1 is a heuristic; on adversarial windows a
  lucky contiguous split can beat it, and a scheduler should never lose to
  its own baseline.  (The property suite asserts cbws >= fifo
  unconditionally on the predicted workloads.)

* **Batch-aware binning** (``buckets=...``) — Algorithm 1 balances workload,
  not count, so its groups land on mismatched padding buckets and waste pad
  rows.  With a bucket set supplied, group *sizes* are planned first
  (``bucket_size_plan``: minimal total pad rows, then most even), and
  requests are dealt into the fixed-size groups heaviest-first onto the
  lightest non-full group — workload balance subject to exact bucket
  occupancy.

* **SLO admission control** (``slo_filter``) — the APRC prediction already
  prices each request, so the admitter can estimate its queue delay
  (cumulative predicted work ahead of it / lanes, scaled by the measured
  seconds-per-work rate) and reject — or degrade to fewer timesteps —
  requests whose predicted latency exceeds the budget.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.balance import balance_ratio
from repro_torch.core.cbws import Partition, cbws_partition, naive_partition
from repro_torch.serving.request import Request

__all__ = ["ADMISSION_POLICIES", "predict_workload", "layer0_channel_weights",
           "admit", "measured_balance", "bucket_size_plan", "slo_filter"]

ADMISSION_POLICIES = ("cbws", "fifo")


def layer0_channel_weights(params: Dict) -> np.ndarray:
    """Per-input-channel downstream-work weight from layer-0 APRC predictions.

    The layer-0 filter magnitude m[cin, cout] = sum_RR w (the paper's
    workload proxy, Eq. 5) predicts how many downstream spike events one unit
    of input drive on channel ``cin`` generates; summed over output channels
    (clamped at 0 — negative net drive virtually never fires under
    reset-by-subtraction) it weights each input channel's density.
    """
    w = params["conv"][0]["w"].detach().cpu().double().numpy()  # (R,R,Cin,Co)
    m = w.sum(axis=(0, 1))                                    # (Cin, Cout)
    return np.maximum(m, 0.0).sum(axis=1)                     # (Cin,)


def predict_workload(frame: np.ndarray, channel_weights: np.ndarray,
                     timesteps: int) -> float:
    """Predicted relative workload of one request.

    Direct coding injects ``frame`` as constant current for T steps, so the
    input spike density per channel is the channel's intensity sum; the
    APRC channel weights turn density into predicted downstream work.
    """
    f = np.asarray(frame, dtype=np.float64)
    density = f.sum(axis=(0, 1))                              # (Cin,)
    return float(timesteps * (density * channel_weights).sum())


# -- batch-aware size planning ----------------------------------------------

def bucket_size_plan(total: int, num_lanes: int, buckets: Sequence[int],
                     max_group: int) -> List[int]:
    """Split ``total`` requests into <= ``num_lanes`` group sizes, each
    <= ``max_group``, minimizing total pad rows (each group pads up to its
    ``bucket_for`` bucket), tie-breaking toward even sizes (smallest max
    group, then more groups).  Deterministic.

    Requires ``total <= max_group * num_lanes`` (the window cap).
    """
    bset = sorted(int(b) for b in buckets)
    cap = min(int(max_group), bset[-1])

    def pad(s: int) -> int:
        for b in bset:
            if s <= b:
                return b - s
        raise ValueError(f"group of {s} exceeds largest bucket {bset[-1]}")

    memo: Dict[Tuple[int, int], Optional[Tuple[int, int, int, Tuple[int, ...]]]] = {}

    def best(rem: int, lanes: int):
        """(total_pad, max_size, -num_groups, sizes) minimal, or None."""
        if rem == 0:
            return (0, 0, 0, ())
        if lanes == 0 or rem > lanes * cap:
            return None
        key = (rem, lanes)
        if key in memo:
            return memo[key]
        win = None
        # prefer exact-bucket sizes first, then the remaining sizes
        candidates = [b for b in bset if b <= min(cap, rem)]
        candidates += [s for s in range(1, min(cap, rem) + 1)
                       if s not in candidates]
        for s in candidates:
            sub = best(rem - s, lanes - 1)
            if sub is None:
                continue
            cand = (pad(s) + sub[0], max(s, sub[1]), sub[2] - 1,
                    (s,) + sub[3])
            if win is None or cand < win:
                win = cand
        memo[key] = win
        return win

    plan = best(int(total), int(num_lanes))
    if plan is None:
        raise ValueError(
            f"cannot split {total} requests across {num_lanes} lanes "
            f"of max_group={max_group}")
    return sorted(plan[3], reverse=True)


def _assign_with_sizes(window: Sequence[Request],
                       sizes: Sequence[int]) -> List[List[Request]]:
    """Workload-balanced deal into fixed-size groups: heaviest request first,
    each onto the currently-lightest group with a seat left (LPT subject to
    exact group sizes).  Deterministic (ties broken by group index)."""
    order = sorted(range(len(window)),
                   key=lambda i: (-window[i].workload, i))
    groups: List[List[Request]] = [[] for _ in sizes]
    sums = [0.0] * len(sizes)
    for i in order:
        open_groups = [k for k in range(len(sizes))
                       if len(groups[k]) < sizes[k]]
        j = min(open_groups, key=lambda k: (sums[k], k))
        groups[j].append(window[i])
        sums[j] += window[i].workload
    return groups


def _fifo_with_sizes(window: Sequence[Request],
                     sizes: Sequence[int]) -> List[List[Request]]:
    """Contiguous FIFO stripes cut to the planned sizes (baseline)."""
    groups, pos = [], 0
    for s in sizes:
        groups.append(list(window[pos:pos + s]))
        pos += s
    return groups


def _predicted(lanes: Sequence[Sequence[Request]]) -> float:
    return balance_ratio(
        [sum(r.workload for r in grp) for grp in lanes if grp] or [1.0])


def _cap_group_sizes(lanes: List[List[Request]], max_group: int) -> None:
    """Enforce the per-lane micro-batch cap in place.

    Algorithm 1 balances *workload*, not count — its fine-tune phase can
    stuff many light requests into one group, overflowing the lane's bucket
    set.  Move the lightest requests of oversized groups into the smallest
    groups (always possible: the window is capped at max_group * num_groups).
    """
    for grp in lanes:
        grp.sort(key=lambda r: -r.workload)
    for grp in lanes:
        while len(grp) > max_group:
            dst = min((g for g in lanes if len(g) < max_group), key=len)
            dst.append(grp.pop())                 # lightest request moves


def admit(window: Sequence[Request], num_lanes: int, policy: str = "cbws",
          max_group: Optional[int] = None,
          buckets: Optional[Sequence[int]] = None,
          ) -> Tuple[List[List[Request]], Partition, float]:
    """Bin one admission window into ``num_lanes`` micro-batches.

    Returns (lane request lists, the partition, predicted balance ratio).
    ``policy="cbws"`` runs Algorithm 1 on the predicted workloads and keeps
    the FIFO stripe instead whenever the stripe *predicts* better balance
    (never-worse guarantee); ``policy="fifo"`` stripes arrival order
    contiguously (the baseline).  ``max_group`` caps each micro-batch's
    size (the engine's per-lane batch/bucket limit); requires
    len(window) <= max_group * num_lanes.  ``buckets`` turns on batch-aware
    binning: group sizes are planned onto padding buckets first
    (``bucket_size_plan``), so no lane wastes pad rows that another size
    split would avoid.
    """
    if policy not in ADMISSION_POLICIES:
        raise ValueError(
            f"unknown admission policy {policy!r}; expected {ADMISSION_POLICIES}")
    n = min(int(num_lanes), len(window))
    if max_group is not None and len(window) > max_group * n:
        raise ValueError(
            f"window of {len(window)} exceeds {max_group} x {n} lanes")
    if n == 0:
        return [], Partition(()), 1.0

    if buckets is not None:
        cap = max_group if max_group is not None else max(buckets)
        sizes = bucket_size_plan(len(window), n, buckets, cap)
        fifo_lanes = _fifo_with_sizes(window, sizes)
        if policy == "fifo":
            lanes = fifo_lanes
        else:
            cbws_lanes = _assign_with_sizes(window, sizes)
            # never-worse guarantee: keep the better-predicted partition
            lanes = (cbws_lanes
                     if _predicted(cbws_lanes) >= _predicted(fifo_lanes)
                     else fifo_lanes)
    else:
        if policy == "cbws":
            part = cbws_partition([r.workload for r in window], n)
            lanes = [[window[i] for i in g] for g in part.groups]
            if max_group is not None:
                _cap_group_sizes(lanes, max_group)
            fifo_part = naive_partition(len(window), n)
            fifo_lanes = [[window[i] for i in g] for g in fifo_part.groups]
            if _predicted(fifo_lanes) > _predicted(lanes):
                lanes = fifo_lanes
        else:
            part = naive_partition(len(window), n)
            lanes = [[window[i] for i in g] for g in part.groups]

    rid_pos = {id(r): i for i, r in enumerate(window)}
    part = Partition(tuple(tuple(rid_pos[id(r)] for r in grp)
                           for grp in lanes))
    return lanes, part, _predicted(lanes)


def measured_balance(lanes: Sequence[Sequence[Request]]) -> float:
    """Balance ratio of the *measured* input-event workload per lane —
    prediction-built partition, actual-workload ratio (the Fig. 7 method
    at request granularity)."""
    sums = [sum(r.events for r in grp) for grp in lanes if grp]
    return balance_ratio(sums or [1.0])


# -- SLO admission control ---------------------------------------------------

def slo_filter(window: Sequence[Request], *, now: float,
               budget_s: Optional[float],
               seconds_per_work: float, num_lanes: int, full_timesteps: int,
               action: str = "reject",
               degrade_timesteps: Optional[int] = None,
               backlog_work: float = 0.0,
               batch_quantum_s: float = 0.0,
               chunk_timesteps: Optional[int] = None,
               ) -> Tuple[List[Request], List[Request], int]:
    """Admission-time SLO control over one FIFO window.

    Each request's predicted latency = time already waited + predicted queue
    delay, where the delay prices ``batch_quantum_s`` (the measured fixed
    per-micro-batch cost: dispatch + padding + launch overhead, paid once
    per batch regardless of its work) plus the cumulative predicted work of
    every admitted request up to and including it — on top of
    ``backlog_work`` already in flight on busy lanes — spread over the
    lanes, at the *marginal* ``seconds_per_work`` rate.  Splitting the
    quantum out matters under tight budgets: the quantum-free model folded
    the fixed cost into the rate, so a window of n requests was priced for
    ~n quanta instead of one and the admitter rejected work that would have
    met its budget (ServingEngine._delay_model fits both terms from
    measured micro-batches).

    ``chunk_timesteps`` prices chunked dispatch explicitly: a request whose
    T runs in ``ceil(T / chunk)`` chunk dispatches pays that many quanta,
    not one — the delay-model samples the quantum is fitted from *are*
    per-dispatch under chunking, so a single-quantum price would understate
    a many-chunk request's fixed costs by exactly ``ceil(T/chunk) - 1``
    quanta.  ``None`` keeps whole-T pricing: one
    dispatch, one quantum.  The engine prices *mid-flight* degrade decisions
    with the same per-remaining-chunk quanta
    (``ServingEngine._mid_flight_degrade``).

    Each request's *limit* is the tighter of the engine-wide ``budget_s``
    (None = unbounded) and its own ``deadline_s`` — a per-request deadline
    prices exactly like a personal SLO budget, so ``degrade`` can fire on a
    per-request basis even on an engine with no global budget.  When the
    deadline is the binding constraint, the dropped request is flagged
    ``deadline_missed`` (the engine fails its handle with
    ``DeadlineExceeded`` rather than ``SLORejected`` and counts it
    separately).

    A request that already burned a failed execution (``r.retries > 0``,
    i.e. its lane died and the micro-batch was re-queued) was admitted once
    and is never re-litigated: re-queued work is served, not re-rejected —
    the engine's no-request-lost guarantee depends on this.  It still
    counts toward the cumulative work pricing everyone behind it.
    (Deadline *expiry* is different — the queue sweep drops an expired
    request whether or not it was re-queued; a lane failure does not extend
    a client's deadline.)

    A request over its limit:

      * ``action="reject"``  — dropped (``r.rejected = True``);
      * ``action="degrade"`` — served with ``degrade_timesteps`` instead of
        the full T.  Fewer timesteps mean proportionally less predicted
        work (Eq. 5's workload factorizes over T), so degrading also speeds
        up everyone queued *behind* the degraded request.  Best-effort:
        degrade mode never drops a request — one that is still over budget
        after degrading, or that cannot be degraded any further
        (``degrade_timesteps`` at or above its current T), is kept as-is;
        the client opted into quality loss, not loss of service.

    Returns (admitted, rejected, newly_degraded_count); admitted requests
    keep their FIFO order, degraded ones carry ``r.timesteps``.
    """
    if action not in ("reject", "degrade"):
        raise ValueError(f"unknown slo action {action!r}")
    admitted: List[Request] = []
    rejected: List[Request] = []
    degraded = 0
    cum_work = float(backlog_work)
    lanes = max(1, int(num_lanes))
    engine_budget = float("inf") if budget_s is None else float(budget_s)

    def quanta(t_r: int) -> int:
        # dispatches a t_r-timestep request needs: ceil(t_r / chunk) under
        # chunked scheduling, one under whole-T
        if chunk_timesteps is None:
            return 1
        return -(-int(t_r) // int(chunk_timesteps))

    for r in window:
        t_r = r.timesteps if r.timesteps is not None else full_timesteps
        eff = r.workload * (t_r / full_timesteps)
        limit = engine_budget
        if r.deadline_s is not None:
            limit = min(limit, float(r.deadline_s))
        if r.retries > 0:             # re-queued after a lane death: always
            admitted.append(r)        # served (admitted once already)
            cum_work += eff
            continue
        waited = max(0.0, now - r.arrival)
        delay = (quanta(t_r) * batch_quantum_s
                 + (cum_work + eff) * seconds_per_work / lanes)
        if waited + delay <= limit:
            admitted.append(r)
            cum_work += eff
            continue
        deadline_bound = (r.deadline_s is not None
                          and waited + delay > float(r.deadline_s))
        if action == "degrade":
            if degrade_timesteps is not None and degrade_timesteps < t_r:
                r.timesteps = int(degrade_timesteps)
                degraded += 1
                cum_work += r.workload * (degrade_timesteps / full_timesteps)
            else:
                cum_work += eff       # cannot degrade further: keep as-is
            admitted.append(r)        # degrade mode never drops a request
        else:
            r.rejected = True
            if deadline_bound:
                r.deadline_missed = True
            rejected.append(r)
    return admitted, rejected, degraded
