"""Serving launcher: SNN frame inference through the ``repro_torch.api``
facade, and LM decoding against prefix caches (``--arch``).

    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --backend hopper --schedule aprc+cbws --batch 256 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --backend batched --batch 4 --steps 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --spec-file serve.json --engine --trace-out trace.json
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --engine --threaded --lanes 2 --slo-ms 50 --slo-action degrade
    PYTHONPATH=src python -m repro_torch.launch.serve --snn snn-mnist \
        --forever --lanes 2      # live submission + per-request futures
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh data=2 \
        --device cpu --batch 4 --steps 2   # batch sharded over 2 entries
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --full-config --batch 4 --prompt-len 64 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --device cpu --batch 2 --prompt-len 16 --new 8   # reduced config

The flags build one validated ``ServeSpec`` (backend, ``--schedule``
kernel schedule, lanes, SLO), or ``--spec-file`` loads one from JSON
(``api.spec_from_dict``); ``--max-queue``, ``--deadline-ms``,
``--chunk-timesteps``, ``--mesh`` and ``--trace-out`` layer over either
source.  ``--mesh`` (``dist.parse_mesh``: ``data=2`` or a bare ``2``)
shards ``Session.infer``'s batch over the mesh and pins the engine's
lanes round-robin to its entries: the cards ``cuda:0..N-1``, or with
``--device cpu`` N host entries.  A
``Session`` executes it, with weights drawn from ``--seed``; frames are
made from the same seed with numpy.

The default path answers ``--steps`` requests, each a batch of
``--batch`` frames, through ``Session.infer`` (the synchronous
single-batch loop); one untimed request first builds the kernels and warms
the caches, and a request is answered when its outputs are on the host.
``--engine`` replays an open-loop trace of ``--steps`` x ``--batch``
single-frame requests with exponential gaps of mean 1 ms (numpy seed 0,
the reference launcher's trace) through the continuous-batching engine
(FIFO windows, CBWS-balanced micro-batch lanes); ``--threaded`` runs its
lanes as worker threads on the wall clock, ``--chunk-timesteps``
reschedules at chunk boundaries, ``--slo-ms`` adds admission-time
latency-budget control (reject or degrade, ``--slo-action``),
``--deadline-ms`` a per-request deadline.  ``--forever`` demonstrates live
submission (``Session.serve_forever`` + per-request futures, threaded
lanes, ``--max-queue`` backpressure).  ``--trace-out`` records the
engine's lifecycle events and writes them as Chrome trace-event JSON
(``obs.export``; load it in Perfetto).

``--arch`` serves a registered LM instead (``reduced`` unless
``--full-config``), the reference's loop: weights from ``--seed`` (made
on the device by a generator there), ``--batch`` prompts of
``--prompt-len`` int32 tokens from numpy, one prefill into bfloat16
caches of ``--prompt-len + --new`` positions, then ``--new - 1`` greedy
decode steps, under ``torch.inference_mode``.  An encoder-only arch
(hubert) has no decode path and exits.  jamba's and rwkv6's chunked
scans take a prompt shorter than their chunk or a multiple of it (128;
16 at ``reduced`` size) and raise ``ValueError`` otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.config import ArchConfig, SNNConfig, get_arch, get_snn, \
    reduced
from repro_torch.core.snn_model import SNN_BACKENDS
from repro_torch.device import resolve_device
from repro_torch.dist.mesh import parse_mesh
from repro_torch.models import transformer
from repro_torch.obs.export import write_chrome_trace
from repro_torch.obs.log import LOG_LEVELS, configure_logging, get_logger

log = get_logger("serve")

SCHEDULES = ("auto", "none", "cbws", "aprc+cbws")


def load_spec_file(path: str, kind):
    """Parse a ``--spec-file`` JSON document into a validated spec via
    ``spec_from_dict`` (its ``kind`` tag dispatches; unknown fields and
    invalid values fail here); a spec of another class than ``kind``
    exits with the reference launcher's words."""
    with open(path) as f:
        spec = api.spec_from_dict(json.load(f))
    if not isinstance(spec, kind):
        use = {api.ServeSpec: "serving", api.TrainSpec: "training"}[kind]
        raise SystemExit(
            f"--spec-file {path} holds a {type(spec).__name__} "
            f"(kind={spec.KIND!r}); {use} needs a {kind.__name__} "
            f"(kind={kind.KIND!r})")
    return spec


def device_name(sess) -> str:
    """The card's name, or "cpu": where a session's numbers were taken."""
    return (torch.cuda.get_device_name(sess.device)
            if sess.device.type == "cuda" else "cpu")


def serve(cfg: SNNConfig, spec: Optional[api.ServeSpec] = None, *,
          backend: str = "hopper", schedule: str = "auto", batch: int = 256,
          steps: int = 8, seed: int = 0, device=None) -> Dict:
    """Answer ``steps`` requests of ``batch`` frames through
    ``Session.infer``, each done when its outputs are on the host; returns
    the counts and times of the timed requests and the last request's
    logits and class predictions.  Without a ``spec``, one is built from
    ``backend`` and ``schedule``."""
    if spec is None:
        spec = api.ServeSpec(
            backend=backend,
            schedule_mode=api.resolve_schedule(schedule, backend))
    sess = api.Session(cfg, spec, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    shape = (batch, *sess.cfg.input_hw, sess.cfg.input_channels)
    requests = [rng.random(shape, dtype=np.float32)
                for _ in range(steps + 1)]
    sess.infer(requests[0])                       # build + warm, untimed
    t0 = time.perf_counter()
    for frames in requests[1:]:
        out = sess.infer(frames)
    seconds = time.perf_counter() - t0
    done = steps * batch
    return {
        "frames": done,
        "seconds": seconds,
        "fps": done / seconds if seconds > 0 else 0.0,
        "spikes_per_frame": sum(float(t) for t in out.spike_totals) / batch,
        "logits": out.logits,
        # outside the clock: numpy's argmax over seg's one-channel pixels
        # takes milliseconds
        "predictions": out.logits.argmax(axis=-1),
        "backend": spec.backend,
        "schedule": spec.schedule_mode or "none",
        "timesteps": sess.cfg.timesteps,
        "device": device_name(sess),
    }


def _write_trace(trace, path: Optional[str], s: Dict) -> None:
    """Export the engine's lifecycle trace as Chrome trace-event JSON
    (``--trace-out``), recording the event count and the write's ms."""
    if not path:
        return
    t0 = time.perf_counter()
    s["trace_events"] = write_chrome_trace(trace, path)
    s["trace_write_ms"] = (time.perf_counter() - t0) * 1e3
    s["trace_out"] = path
    log.info("wrote %d trace events to %s in %.1f ms", s["trace_events"],
             path, s["trace_write_ms"])


def serve_engine(cfg: SNNConfig, spec: api.ServeSpec, *, batch: int = 8,
                 steps: int = 8, forever: bool = False, seed: int = 0,
                 device=None, trace_out: Optional[str] = None) -> Dict:
    """Serve ``steps * batch`` single-frame requests through the
    continuous-batching engine ``spec`` configures: replayed on the
    open-loop exponential-gap trace (``forever=False``), or submitted live
    to ``serve_forever``.  Returns the engine's metrics summary, plus the
    live outcomes, the micro-batches the trace recorded (0 untraced) and,
    with ``trace_out``, the trace file's event count and write time."""
    if trace_out and not spec.trace:
        spec = dataclasses.replace(spec, trace=True)
    sess = api.Session(cfg, spec, seed=seed, device=device)
    frames = np.random.default_rng(seed).random(
        (batch, *sess.cfg.input_hw, sess.cfg.input_channels),
        dtype=np.float32)
    n = steps * batch
    if forever:
        live = sess.serve_forever()
        handles = [live.submit(frames[i % batch]) for i in range(n)]
        snap = live.metrics()
        log.info("mid-burst snapshot: served=%d queued=%d in_flight=%d "
                 "lanes=%d/%d", snap.served, snap.queued, snap.in_flight,
                 snap.lanes_alive, snap.lanes_total)
        # exception() instead of result(): with --slo-ms an over-budget
        # submission resolves to SLORejected, an outcome to count here
        outcomes = [h.exception(timeout=60.0) for h in handles]
        s = dict(live.shutdown())
        s["futures_resolved"] = sum(e is None for e in outcomes)
        s["futures_failed"] = sum(e is not None for e in outcomes)
        trace = live.trace()
    else:
        eng = sess.engine()
        gaps = np.random.default_rng(0).exponential(1e-3, n)
        for i, arr in enumerate(np.cumsum(gaps)):
            eng.submit(frames[i % batch], arrival=float(arr))
        s = eng.run()
        trace = eng.trace
    s["mode"] = ("forever" if forever else
                 "threaded" if spec.threaded else "virtual")
    s["micro_batches"] = len(trace.events("dispatch"))
    s["device"] = device_name(sess)
    _write_trace(trace, trace_out, s)
    return s


def spec_from_args(args) -> api.ServeSpec:
    """The ``ServeSpec`` of the command line: ``--spec-file``, or the
    per-flag spec, with the layered flags applied over it
    (``--trace-out`` turns ``trace`` on in ``serve_engine``)."""
    if args.spec_file:
        spec = load_spec_file(args.spec_file, api.ServeSpec)
    else:
        # a mesh serves canonical weights: "auto" then picks no schedule
        schedule = ("none" if args.mesh and args.schedule == "auto"
                    else args.schedule)
        spec = api.ServeSpec(
            backend=args.backend,
            schedule_mode=api.resolve_schedule(schedule, args.backend),
            num_lanes=args.lanes, max_batch=args.batch or 8,
            threaded=args.threaded,
            latency_budget_s=args.slo_ms / 1e3 if args.slo_ms else None,
            slo_action=args.slo_action)
    # these flags layer onto either spec source (explicit flags win)
    overrides = {}
    if args.max_queue is not None:
        overrides["max_queue"] = args.max_queue
    if args.deadline_ms is not None:
        overrides["default_deadline_s"] = args.deadline_ms / 1e3
    if args.chunk_timesteps is not None:
        overrides["chunk_timesteps"] = args.chunk_timesteps
    if args.mesh:
        overrides["mesh"] = parse_mesh(args.mesh)
    return dataclasses.replace(spec, **overrides) if overrides else spec


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 64,
             new: int = 32, seed: int = 0, device=None,
             params: Optional[transformer.Transformer] = None,
             prompts: Optional[np.ndarray] = None) -> Dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``new - 1`` greedy steps.  ``params`` default to weights drawn from
    ``seed`` on ``device`` (default: the card), ``prompts`` to int32 ids
    from numpy ``seed`` (given ones set the batch and the prompt length).
    Returns the generated ids (batch, new), the last
    step's logits, the prefill's and each decode step's seconds (each
    ended by a device sync), and the weights (``params``)."""
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    dev = resolve_device(device)
    if params is None:
        params = transformer.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    if prompts is None:
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)
    prompts = np.asarray(prompts, dtype=np.int32)
    batch, prompt_len = prompts.shape
    tokens = torch.from_numpy(prompts).to(dev)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(
            params, cfg, tokens=tokens, remat=False,
            max_len=prompt_len + new, cache_dtype=torch.bfloat16)
        token = logits[:, -1:].argmax(-1).to(torch.int32)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        generated, step_s = [token], []
        for i in range(new - 1):
            t0 = time.perf_counter()
            logits, caches = transformer.decode_step(
                params, caches, cfg, token=token, pos=prompt_len + i)
            token = logits.argmax(-1).to(torch.int32)
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            generated.append(token)
    decode_s = sum(step_s)
    n = batch * len(step_s)
    return {
        "arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
        "new": new, "tokens": torch.cat(generated, 1).cpu().numpy(),
        "logits": logits.float().cpu().numpy(),
        "prefill_seconds": prefill_s,
        "prefill_tokens_per_s": batch * prompt_len / prefill_s,
        "decode_step_seconds": step_s, "decode_seconds": decode_s,
        "decode_tokens": n,
        "decode_tokens_per_s": n / decode_s if decode_s > 0 else 0.0,
        "params": params,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", default="snn-mnist")
    ap.add_argument("--arch", default=None,
                    help="serve a registered LM (repro_torch.config."
                         "list_archs) instead of an SNN")
    ap.add_argument("--full-config", action="store_true",
                    help="--arch at its published widths and depth "
                         "(default: config.reduced)")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="--arch: prompt tokens per sequence")
    ap.add_argument("--new", type=int, default=32,
                    help="--arch: tokens generated per sequence")
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS)
    ap.add_argument("--schedule", default="auto", choices=SCHEDULES,
                    help="kernel-level CBWS channel schedule (hopper "
                         "backend only; 'auto' = aprc+cbws on hopper without "
                         "--mesh, none otherwise; a mode on another backend "
                         "or with --mesh is a ServeSpec error)")
    ap.add_argument("--spec-file", default=None,
                    help="JSON ServeSpec (api.spec_from_dict; kind='serve'), "
                         "in place of the per-flag spec; --max-queue, "
                         "--deadline-ms, --chunk-timesteps and --trace-out "
                         "still layer on top")
    ap.add_argument("--batch", type=int, default=None,
                    help="frames per request (default 256), or the engine's "
                         "largest micro-batch (default 8, or the spec "
                         "file's max_batch), or with --arch the prompts "
                         "(default 4)")
    ap.add_argument("--steps", type=int, default=8,
                    help="timed requests (after one untimed warm-up), or "
                         "x --batch single-frame engine requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine on "
                         "an open-loop exponential-gap trace")
    ap.add_argument("--forever", action="store_true",
                    help="live serving demo: serve_forever() with "
                         "submissions while the engine runs (threaded)")
    ap.add_argument("--lanes", type=int, default=2,
                    help="engine micro-batch lanes")
    ap.add_argument("--threaded", action="store_true",
                    help="run engine lanes as worker threads on the wall "
                         "clock")
    ap.add_argument("--chunk-timesteps", type=int, default=None,
                    help="engine: run T in chunks of this many timesteps, "
                         "rescheduling at every chunk boundary")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="admission latency budget in ms; over-budget "
                         "requests are rejected/degraded")
    ap.add_argument("--slo-action", default="reject",
                    choices=("reject", "degrade"),
                    help="what to do with over-budget requests")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded-queue backpressure: live submissions "
                         "beyond this depth fail fast with QueueFull")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline in ms; requests "
                         "expired in queue fail with DeadlineExceeded")
    ap.add_argument("--mesh", default="",
                    help="repro_torch.dist mesh string, e.g. 'data=2' or "
                         "bare '2': shards infer over the device mesh and "
                         "pins engine lanes round-robin to its entries "
                         "(with --device cpu, N host entries)")
    ap.add_argument("--trace-out", default=None,
                    help="record the engine's lifecycle events "
                         "(ServeSpec.trace) and write Chrome trace-event "
                         "JSON here (with --engine/--forever)")
    ap.add_argument("--log-level", default="info", choices=LOG_LEVELS,
                    help="stderr log verbosity (repro_torch.obs.log)")
    args = ap.parse_args(argv)
    configure_logging(args.log_level)
    if args.arch:
        cfg = get_arch(args.arch)
        cfg = cfg if args.full_config else reduced(cfg)
        s = serve_lm(cfg, batch=args.batch or 4, prompt_len=args.prompt_len,
                     new=args.new, seed=args.seed, device=args.device)
        log.info("served %d tokens in %.4fs (%.1f tokens/s decode, prefill "
                 "%dx%d in %.4fs, arch=%s, device=%s)", s["decode_tokens"],
                 s["decode_seconds"], s["decode_tokens_per_s"], s["batch"],
                 s["prompt_len"], s["prefill_seconds"], cfg.name,
                 s["device"])
        return s
    cfg = get_snn(args.snn)
    spec = spec_from_args(args)
    if args.engine or args.forever:
        s = serve_engine(cfg, spec, batch=args.batch or spec.max_batch,
                         steps=args.steps, forever=args.forever,
                         seed=args.seed, device=args.device,
                         trace_out=args.trace_out)
        log.info("engine[%s] served %.0f frames in %.0f rounds (%.1f FPS, "
                 "backend=%s, lanes=%d, p50=%.1fms, p99=%.1fms, "
                 "balance=%.3f, rejected=%.0f, degraded=%.0f, "
                 "deadline_missed=%.0f, device=%s)", s["mode"], s["served"],
                 s["rounds"], s["fps"], spec.backend, spec.num_lanes,
                 s["p50_latency_s"] * 1e3, s["p99_latency_s"] * 1e3,
                 s["request_balance"], s["rejected"], s["degraded"],
                 s["deadline_missed"], s["device"])
        return s
    s = serve(cfg, spec, batch=args.batch or 256, steps=args.steps,
              seed=args.seed, device=args.device)
    log.info("served %d frames in %.4fs (%.1f FPS, backend=%s, "
             "schedule=%s, T=%d, total_spikes/frame=%.0f, device=%s)",
             s["frames"], s["seconds"], s["fps"], s["backend"], s["schedule"],
             s["timesteps"], s["spikes_per_frame"], s["device"])
    return s


if __name__ == "__main__":
    main()
