"""The traffic generator of the spiking networks: how a window drives the
program, by the ``mode`` that a traffic file names, with the mix's
parameters from that file (``families/snn.py`` lists the modes).

- ``closed_infer``: one caller of ``Session.infer`` in a closed loop over a
  pool of batches drawn from the seed; outputs on the host every call.
- ``open_loop``: single-frame requests into ``Session.serve_forever`` at
  Poisson arrivals of a fixed rate.  Every seed gets the same set of gaps
  (the exponential law's quantiles) in its own order, so the seed changes
  which frame comes when, not how much load there is.  Each request is
  timed from its due time to its output on the host, on the benchmark's
  clock.
- ``closed_train``: ``Session.train_step`` in a closed loop over a pool of
  labelled batches, the loss read every step.

A driver makes the weights and inputs (``setup``), runs the window
(``window``, which sets ``readings["attempted"]``), frees the program
(``release``), and then compares what the timed path produced with the
plain reference (``check``).  ``controlled`` gives the same comparison
with the reference, computed in TF32, in the program's place: the control
that the limits are set against.  ``Driver`` holds what every family's
drivers share; ``SNNDriver`` adds the networks' weights and specs.

Each mode's ``SMALL_MIX`` is the mix that the CPU rehearsal
(``skybench/tests``) lays over a traffic file, with the family's
``narrow`` cut of the network.  ``ClosedInfer`` takes what belongs to the
network from methods that another family's subclass overrides: the inputs
(``draw_inputs``), the weights (``weights``), the program (``program``),
the reference (``reference_blocks``) and the work (``layer_work``,
``firing``).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from skybench import work
from skybench.data.weights import make_weights
from skybench.inputs import draw_frames, sub_seed
from skybench.reference import snn as ref
from skybench.trace import span

__all__ = ["Driver", "SNNDriver", "ClosedInfer", "OpenLoop", "ClosedTrain"]

TRACE_AFTER_S = 1.0      # the profiler starts this far into the window
TRACE_FOR_S = 3.0        # and traces this long (less in a shorter window)
DRAIN_S = 60.0           # how long answers may come after the window
LOOK = 64                # the open loop's collector looks this far ahead


def _clone(tree, zero: bool = False):
    """A copy of a tree of dicts, lists and tensors (zeros with ``zero``)."""
    if isinstance(tree, dict):
        return {k: _clone(v, zero) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v, zero) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree) if zero else tree.detach().clone()
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    return [p[k] for g in ("conv", "dense") for p in tree[g]
            for k in ("w", "b")]


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


class Driver:
    """What every mode shares: the run's context, spans, the profiler's
    part of the window."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.model = ctx.model
        self.mix = ctx.traffic
        self.device = ctx.device
        self.trace = ctx.trace
        self.readings: Dict = {}

    def span(self, name: str):
        return span(name, self.trace.active)

    def trace_due(self, t0: float, seconds: float) -> None:
        """Start or stop the profiler at its part of the window that began
        at ``t0``: from ``TRACE_AFTER_S`` in, for ``TRACE_FOR_S`` from the
        moment it runs, and never past the window's end."""
        elapsed = time.perf_counter() - t0
        after = min(TRACE_AFTER_S, 0.2 * seconds)
        if not self.trace.started and elapsed >= after:
            self.trace.start()
            self._trace_from = time.perf_counter() - t0
        elif self.trace.active \
                and elapsed >= min(self._trace_from + TRACE_FOR_S, seconds):
            self.trace.stop()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.sess = self.live = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class SNNDriver(Driver):
    """The spiking networks' weights and serving spec."""

    def weights(self) -> Dict:
        w = self.ctx.config["weights"]
        return make_weights(self.model, float(w["sigma"]), self.ctx.seed,
                            self.device)

    def serve_spec(self, **kw):
        from repro_torch.api import ServeSpec
        ex = self.ctx.config["execution"]
        return ServeSpec(backend=ex["backend"],
                         schedule_mode=ex["schedule_mode"], **kw)


class ClosedInfer(SNNDriver):
    """Bulk scoring: one closed-loop caller of the program's ``infer``
    (``Session.infer``).

    Nothing here looks at an input past its first (batch) axis, so a
    family whose inputs are clips (B, T, H, W, C) overrides the methods
    from ``draw_inputs`` on and keeps the window, the check and the
    readings that the ``*.infer`` readers read."""

    SMALL_MIX = dict(batch=4, pool_batches=2, ref_block=4)

    def draw_inputs(self, n: int) -> np.ndarray:
        """``n`` inputs from the seed, stacked on the first axis."""
        return draw_frames(self.mix["frames"], n, self.model,
                           sub_seed(self.ctx.seed, 1))[0]

    def program(self, params):
        """The system under test on ``params``: its ``infer(batch)`` gives
        ``logits`` and ``timestep_counts`` (per layer, (T, C)) on the
        host."""
        from repro_torch.api import Session
        return Session(self.ctx.cfg, self.serve_spec(), params=params,
                       device=self.device)

    def reference_blocks(self, x: torch.Tensor, control: bool):
        """The plain reference over one batch ``x``, ``ref_block`` inputs
        at a time: ``logits``, ``counts`` (per layer, (T, C)) and ``taps``
        (per layer)."""
        return ref.forward_blocks(self.model, self.ref_params, x,
                                  int(self.mix["ref_block"]),
                                  control=control)

    def layer_work(self, taps, frames: float, calls: float):
        """The layers' work of ``frames`` inputs in ``calls`` calls, from
        the reference's ``taps`` per input."""
        return work.infer_work(self.model, taps, frames, calls)

    def firing(self, refs, n_frames: int) -> List[float]:
        """Each layer's spikes per neuron and step in the reference."""
        return _firing(self.model, refs, n_frames)

    def setup(self) -> None:
        batch, n_pool = int(self.mix["batch"]), int(self.mix["pool_batches"])
        x = self.draw_inputs(batch * n_pool)
        self.pool = [x[i * batch:(i + 1) * batch] for i in range(n_pool)]
        params = self.weights()
        self.ref_params = _clone(params)
        self.sess = self.program(params)
        for xb in self.pool:                 # builds and warms every shape
            self.sess.infer(xb)
        self.sync()

    def window(self, seconds: float) -> Dict[str, float]:
        batch = self.pool[0].shape[0]
        self.calls: List = []
        traced, t0 = 0, time.perf_counter()
        while True:
            if time.perf_counter() - t0 >= seconds:
                break
            self.trace_due(t0, seconds)
            k = len(self.calls) % len(self.pool)
            with self.span("infer"):
                out = self.sess.infer(self.pool[k])
            if self.trace.active:
                traced += 1
            self.calls.append((k, out.logits, [np.asarray(c) for c in
                                               out.timestep_counts]))
        t1 = time.perf_counter()
        self.trace.stop()
        frames = len(self.calls) * batch
        self.readings.update(window_s=t1 - t0, frames_window=frames,
                             attempted=frames, calls_window=len(self.calls),
                             calls_traced=traced, frames_traced=traced * batch)
        return {"infer_fps": frames / (t1 - t0)}

    def _reference(self, control: bool):
        ref.exact_float32()
        return [self.reference_blocks(torch.as_tensor(xb, device=self.device),
                                      control) for xb in self.pool]

    def _numbers(self, answers, refs) -> Dict[str, float]:
        """``answers``: (pool index, logits, counts) of each call.
        ``count_gap``: the worst layer's spikes that differ, by step and
        channel, as a share of its spikes; ``logit_gap``: the widest logit
        gap of any frame, over the logits' rms; ``logit_p99``: the 99th
        percentile of the frames' widest gaps; ``mean_gap``: the mean
        logit gap over the mean logit."""
        count_gap = gap = total = 0.0
        scale = max(_rms(r.logits.cpu().numpy()) for r in refs)
        ref_np = [(r.logits.cpu().numpy(), [c.cpu().numpy() for c in r.counts])
                  for r in refs]
        per_frame = []
        for k, logits, counts in answers:
            rl, rc = ref_np[k]
            d = np.abs(logits - rl).reshape(len(rl), -1)
            per_frame.append(d.max(axis=1) / scale)
            gap += float(d.sum())
            total += float(np.abs(rl).sum())
            for pc, c in zip(counts, rc):
                share = np.abs(pc - c).sum() / max(float(c.sum()), 1.0)
                count_gap = max(count_gap, float(share))
        per_frame = np.concatenate(per_frame)
        return {"count_gap": count_gap,
                "logit_gap": float(per_frame.max()),
                "logit_p99": float(np.percentile(per_frame, 99)),
                "mean_gap": gap / max(total, 1e-30)}

    def check(self) -> Dict[str, float]:
        refs = self._reference(control=False)
        self._work(refs)
        return self._numbers(self.calls, refs)

    def controlled(self) -> Dict[str, float]:
        refs = self._reference(control=False)
        ctl = self._reference(control=True)
        answers = [(k, c.logits.cpu().numpy(),
                    [x.cpu().numpy() for x in c.counts])
                   for k, c in enumerate(ctl)]
        return self._numbers(answers, refs)

    def _work(self, refs) -> None:
        n = sum(xb.shape[0] for xb in self.pool)
        taps = [sum(r.taps[i] for r in refs) / n
                for i in range(len(refs[0].taps))]
        self.readings["taps_per_frame"] = taps
        self.readings["firing"] = self.firing(refs, n)
        batch = self.pool[0].shape[0]
        r = self.readings
        r["work_window"] = self.layer_work(taps, r["frames_window"],
                                           r["calls_window"])
        r["work_traced"] = self.layer_work(taps, r["frames_traced"],
                                           r["frames_traced"] / batch)


class OpenLoop(SNNDriver):
    """Single-frame requests at Poisson arrivals into the live engine."""

    SMALL_MIX = dict(pool_frames=6, rate_per_s=40, warm_requests=4,
                     check_requests=20, max_batch=4)

    def setup(self) -> None:
        from repro_torch.api import Session
        m = self.mix
        self.frames, _ = draw_frames(m["frames"], int(m["pool_frames"]),
                                     self.model, sub_seed(self.ctx.seed, 1))
        params = self.weights()
        self.ref_params = _clone(params)
        spec = self.serve_spec(
            num_lanes=int(m["lanes"]), max_batch=int(m["max_batch"]),
            admission=m["admission"], trace=self.trace.on,
            trace_capacity=int(m["trace_capacity"]))
        self.sess = Session(self.ctx.cfg, spec, params=params,
                            device=self.device)
        self.live = self.sess.serve_forever()     # warms every bucket
        # the lanes' threads and buffers at the cell's own load
        rate = float(m["rate_per_s"])
        warm, t0 = [], time.perf_counter()
        for i in range(int(m["warm_requests"])):
            _sleep_until(t0 + i / rate)
            warm.append(self.live.submit(self.frames[i % len(self.frames)]))
        for h in warm:
            h.result(timeout=DRAIN_S)
        self.sync()

    def _arrivals(self, n: int, rate: float) -> np.ndarray:
        """Gaps of a Poisson process at ``rate``: the exponential law's
        ``n`` quantiles (the same for every seed) in the seed's order."""
        q = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-q) / rate
        rng = np.random.default_rng(sub_seed(self.ctx.seed, 2))
        return np.cumsum(rng.permutation(gaps))

    def window(self, seconds: float) -> Dict[str, float]:
        m = self.mix
        rate = float(m["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        due_off = self._arrivals(n, rate)
        rng = np.random.default_rng(sub_seed(self.ctx.seed, 3))
        which = rng.integers(0, len(self.frames), n)
        keep = set(rng.choice(n, size=min(n, int(m["check_requests"])),
                              replace=False).tolist())
        self.handles = [None] * n
        self.done_at = np.full(n, np.inf)
        self.answers: Dict[int, np.ndarray] = {}
        self.errors: Dict[int, BaseException] = {}
        submitted = collections.deque()
        cv = threading.Condition()
        finished = threading.Event()

        def collect():
            # answers come nearly in due order: at most the requests in
            # flight on the lanes finish out of it, so each pass waits on
            # the oldest and looks at the next ``LOOK`` only
            pending: collections.deque = collections.deque()
            while True:
                with cv:
                    while submitted:
                        pending.append(submitted.popleft())
                    closing = finished.is_set()
                if not pending:
                    if closing:
                        return
                    with cv:
                        cv.wait(0.001)
                    continue
                try:
                    pending[0][1].exception(timeout=0.001)
                except TimeoutError:
                    pass
                now, rest = time.perf_counter(), []
                with span("collect", self.trace.active):
                    for _ in range(min(LOOK, len(pending))):
                        i, h = pending.popleft()
                        if not h.done():
                            rest.append((i, h))
                            continue
                        self.done_at[i] = now
                        exc = h.exception(timeout=0)
                        if exc is not None:
                            self.errors[i] = exc
                        elif i in keep:
                            self.answers[i] = h.result(timeout=0)
                pending.extendleft(reversed(rest))
                if closing and time.perf_counter() > self._close + DRAIN_S:
                    return

        self._close = float("inf")
        collector = threading.Thread(target=collect, name="skybench-collect")
        collector.start()
        late = np.zeros(n)
        traced = 0
        t0 = time.perf_counter()
        due = t0 + due_off
        try:
            for i in range(n):
                _sleep_until(due[i])
                self.trace_due(t0, seconds)
                late[i] = time.perf_counter() - due[i]
                with self.span("submit"):
                    h = self.live.submit(self.frames[which[i]])
                if self.trace.active:
                    traced += 1
                self.handles[i] = h
                with cv:
                    submitted.append((i, h))
                    cv.notify()
            _sleep_until(t0 + seconds)
            self.trace.stop()
        finally:
            self._close = time.perf_counter()
            finished.set()
            collector.join()
        self.summary = self.live.shutdown(timeout=DRAIN_S)
        self.events = self.live.trace().events() if self.trace.on else []
        self.which = which
        lat = (self.done_at - due) * 1e3
        failed = int(np.sum(~np.isfinite(lat))) + len(self.errors)
        lat[list(self.errors)] = np.inf
        self.failed = failed
        self.latency_ms = lat
        self.readings.update(
            window_s=seconds, frames_window=n, attempted=n, requests=n,
            frames_traced=traced, rids=[h.rid for h in self.handles],
            late_p95_ms=float(np.percentile(late, 95) * 1e3),
            late_max_ms=float(late.max() * 1e3))
        return {"p95_ms": float(np.percentile(lat, 95, method="higher"))}

    def _reference(self, idx: List[int], control: bool):
        ref.exact_float32()
        x = torch.as_tensor(self.frames[idx], device=self.device)
        return ref.forward_blocks(self.model, self.ref_params, x,
                                  int(self.mix["ref_block"]),
                                  control=control)

    def _numbers(self, answers: Dict[int, np.ndarray], logits: np.ndarray,
                 row: Dict[int, int]) -> Dict[str, float]:
        """``logit_gap``: the widest gap of any pixel's logit, over the
        logits' rms; ``logit_p99``: the 99th percentile of the requests'
        widest gaps; ``mean_gap``: the mean gap over the mean logit."""
        scale = _rms(logits)
        gap = total = 0.0
        worst = []
        for i, a in answers.items():
            d = np.abs(a.reshape(logits.shape[1:]) - logits[row[i]])
            worst.append(float(d.max()) / scale)
            gap += float(d.sum())
            total += float(np.abs(logits[row[i]]).sum())
        return {"logit_gap": max(worst),
                "logit_p99": float(np.percentile(worst, 99)),
                "mean_gap": gap / max(total, 1e-30)}

    def check(self) -> Dict[str, float]:
        frames = sorted({int(self.which[i]) for i in self.answers})
        out = self._reference(frames, control=False)
        row = {i: frames.index(int(self.which[i])) for i in self.answers}
        self._work(out, len(frames))
        nums = self._numbers(self.answers, out.logits.cpu().numpy(), row)
        nums["missing"] = float(len(self.errors)
                                + sum(1 for i in range(len(self.handles))
                                      if not np.isfinite(self.done_at[i])))
        return nums

    def controlled(self) -> Dict[str, float]:
        idx = list(range(len(self.frames)))
        fp32 = self._reference(idx, control=False).logits.cpu().numpy()
        ctl = self._reference(idx, control=True).logits.cpu().numpy()
        return self._numbers(dict(enumerate(ctl)), fp32,
                             {i: i for i in idx})

    def _work(self, out, n_frames: int) -> None:
        r = self.readings
        taps = [t / n_frames for t in out.taps]
        r["taps_per_frame"] = taps
        r["firing"] = _firing(self.model, [out], n_frames)
        disp = [e for e in self.events if e.kind == "dispatch"]
        per_batch = (np.mean([e.get("n") for e in disp]) if disp
                     else float(self.mix["max_batch"]))
        n = r["frames_window"] - self.failed
        r["work_window"] = work.infer_work(self.model, taps, n,
                                           n / per_batch)
        r["work_traced"] = work.infer_work(self.model, taps,
                                           r["frames_traced"],
                                           r["frames_traced"] / per_batch)


class ClosedTrain(SNNDriver):
    """``Session.train_step`` in a closed loop, the loss read every step.

    Set-up builds the session and drives it through its first steps, on
    the pool's first batches: the reference follows those steps."""

    SMALL_MIX = dict(batch=4, pool_batches=4)

    def setup(self) -> None:
        from repro_torch.api import Session, TrainSpec
        m = self.mix
        batch, n_pool = int(m["batch"]), int(m["pool_batches"])
        x, y = draw_frames(m["frames"], batch * n_pool, self.model,
                           sub_seed(self.ctx.seed, 1))
        self.pool = [(x[i * batch:(i + 1) * batch],
                      y[i * batch:(i + 1) * batch]) for i in range(n_pool)]
        params = self.weights()
        self.ref_params = _clone(params)
        ex = self.ctx.config["execution"]
        self.sess = Session(self.ctx.cfg, TrainSpec(
            backend=ex["backend"], lr=float(m["lr"]),
            momentum=float(m["momentum"])), params=params, device=self.device)
        self.first_losses, self.first_grad = [], None
        for k in range(int(m["checked_steps"])):
            self.first_losses.append(self.sess.train_step(*self.pool[k]))
            if k == 0:       # the optimizer's state: the first gradient
                mom = self.sess._mom
                self.first_grad = (_clone(mom) if mom is not None else
                                   _clone(self.ref_params, zero=True))
        self.after = _clone(self.sess.params)
        self.next = int(m["checked_steps"])
        self.sync()

    def window(self, seconds: float) -> Dict[str, float]:
        batch = self.pool[0][0].shape[0]
        self.losses: List[float] = []
        traced, t0 = 0, time.perf_counter()
        while True:
            if time.perf_counter() - t0 >= seconds:
                break
            self.trace_due(t0, seconds)
            xb, yb = self.pool[(self.next + len(self.losses)) % len(self.pool)]
            with self.span("train_step"):
                self.losses.append(self.sess.train_step(xb, yb))
            if self.trace.active:
                traced += 1
        t1 = time.perf_counter()
        self.trace.stop()
        steps = len(self.losses)
        self.readings.update(window_s=t1 - t0, frames_window=steps * batch,
                             attempted=steps * batch, steps_window=steps,
                             steps_traced=traced, frames_traced=traced * batch)
        return {"train_fps": steps * batch / (t1 - t0)}

    def _reference(self, control: bool):
        ref.exact_float32()
        m = self.mix
        batches = [(torch.as_tensor(x, device=self.device),
                    torch.as_tensor(y, device=self.device))
                   for x, y in self.pool[:int(m["checked_steps"])]]
        return ref.train_steps(self.model, self.ref_params, batches,
                               lr=float(m["lr"]),
                               momentum=float(m["momentum"]),
                               control=control)

    def _numbers(self, losses, grad, after, rec) -> Dict[str, float]:
        """Each step's loss; the first gradient's and the three steps'
        change's norms, leaf by leaf, against the reference's."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, rec.losses))
        g_ref = [t.norm().item() for t in _leaves(rec.first_grad)]
        g_med = float(np.median(g_ref))
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone: they are left out
        live = [i for i, g in enumerate(g_ref) if g >= 1e-3 * g_med]

        def gaps(port, refn):
            med = float(np.median([refn[i] for i in live]))
            return [abs(port[i] - refn[i]) / max(refn[i], med) for i in live]

        p0 = _leaves(self.ref_params)
        d_ref = [(a - b).norm().item()
                 for a, b in zip(_leaves(rec.params), p0)]
        d_port = [(a.to(b.device) - b).norm().item()
                  for a, b in zip(_leaves(after), p0)]
        g_port = [t.norm().item() for t in _leaves(grad)]
        grad_gaps, update_gaps = gaps(g_port, g_ref), gaps(d_port, d_ref)
        self.leaf_gaps = {"grad": grad_gaps, "update": update_gaps,
                          "leaves": live}
        return {"loss_gap": loss_gap, "grad_gap": max(grad_gaps),
                "update_gap": max(update_gaps)}

    def check(self) -> Dict[str, float]:
        rec = self._reference(control=False)
        self._work(rec)
        nums = self._numbers(self.first_losses, self.first_grad, self.after,
                             rec)
        bad = sum(1 for v in self.losses if not np.isfinite(v))
        nums["bad_losses"] = float(bad)
        return nums

    def controlled(self) -> Dict[str, float]:
        rec = self._reference(control=False)
        ctl = self._reference(control=True)
        return self._numbers(ctl.losses, ctl.first_grad, ctl.params, rec)

    def _work(self, rec) -> None:
        r = self.readings
        batch = self.pool[0][0].shape[0]
        taps = [t / batch for t in rec.outputs.taps]
        r["taps_per_frame"] = taps
        r["firing"] = _firing(self.model, [rec.outputs], batch)
        r["work_window"] = work.train_work(self.model, taps,
                                           r["frames_window"],
                                           r["steps_window"])
        r["work_traced"] = work.train_work(self.model, taps,
                                           r["frames_traced"],
                                           r["steps_traced"])


def _firing(model: Dict, outs, n_frames: int) -> List[float]:
    """Each conv layer's spikes per neuron and step."""
    t_steps = model["timesteps"]
    out = []
    h, w = model["input_hw"]
    r = model["kernel_size"]
    for i, cout in enumerate(model["conv_channels"]):
        if model["aprc"]:
            h, w = h + r - 1, w + r - 1
        spikes = sum(float(o.counts[i].sum()) for o in outs)
        out.append(spikes / (n_frames * t_steps * h * w * cout))
    return out


def _sleep_until(t: float) -> None:
    d = t - time.perf_counter()
    if d > 0:
        time.sleep(d)
