"""Batched serving on the PyTorch port: batched SNN frame inference
through the selectable backend, or an LM's prefill of a batch of prompts
followed by greedy decoding with the production cache machinery (ring
buffers for sliding layers); the port of the reference's
``examples/serve_batched.py``.

    PYTHONPATH=src python examples/torch_serve_batched.py --snn snn-mnist \
        --batch 8
    PYTHONPATH=src python examples/torch_serve_batched.py --snn snn-mnist \
        --threaded --lanes 2        # worker-thread lanes vs single thread
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu \
        --backend batched --batch 2
    PYTHONPATH=src python examples/torch_serve_batched.py --arch gemma3-4b \
        --new 32 --device cpu       # reduced config

The default A/B serves one batch through the timestep-outer ``ref``
backend and through ``--backend`` (``hopper``, the default: the kernels on
the card), both through ``Session.serve``; ``--threaded`` A/Bs the
worker-thread engine against the single-thread virtual-clock engine on a
skewed burst.  ``--arch`` serves the arch's ``reduced`` config: weights
and prompts from seed 0, one prefill, ``--new - 1`` decode steps
(``launch.serve.serve_lm``), with the prefill's time, the decode rate and
a sample of the generated ids.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np

from repro_torch import api
from repro_torch.config import ArchConfig, SNNConfig, get_arch, get_snn, \
    reduced
from repro_torch.core import SNN_BACKENDS
from repro_torch.launch.serve import serve_lm
from repro_torch.obs.log import configure_logging, get_logger

log = get_logger("examples")


def serve_snn_batched(cfg: SNNConfig, *, params: Optional[Dict] = None,
                      frames: Optional[np.ndarray] = None,
                      backend: str = "hopper", batch: int = 4,
                      chunk_timesteps: Optional[int] = None,
                      device=None) -> Dict:
    """A/B the seed scan (``ref``) against ``backend``, both through
    ``Session.serve`` (4 timed iterations of one batch); ``frames``
    default to ``batch`` uniform frames from numpy seed 1.  Returns the ms
    per batch and FPS of each backend, the speedup, and each backend's
    outputs (on the host)."""
    sess = api.Session(cfg, params=params, device=device)
    if frames is None:
        frames = np.random.default_rng(1).random(
            (batch, *cfg.input_hw, cfg.input_channels), dtype=np.float32)
    ms, fps, outputs = {}, {}, {}
    for b in dict.fromkeys(("ref", backend)):
        spec_sess = api.Session(
            cfg, api.ServeSpec(backend=b, chunk_timesteps=chunk_timesteps),
            params=sess.params, device=sess.device)
        s = spec_sess.serve(frames, steps=4)
        ms[b] = s["seconds"] / 4 * 1e3
        fps[b], outputs[b] = s["fps"], s["outputs"]
        log.info("%8s: %6.1f ms/batch (%.1f FPS)", b, ms[b], fps[b])
        if not np.isfinite(s["outputs"].logits).all():
            raise AssertionError(f"backend {b} gave non-finite logits")
    speedup = ms["ref"] / ms[backend]
    if backend != "ref":
        log.info("time-batched speedup vs seed scan: %.2fx", speedup)
    return {"ms_per_batch": ms, "fps": fps, "speedup": speedup,
            "outputs": outputs}


def serve_snn_threaded(cfg: SNNConfig, *, params: Optional[Dict] = None,
                       backend: str = "hopper", batch: int = 4,
                       lanes: int = 2, chunk_timesteps: Optional[int] = None,
                       device=None) -> Dict:
    """A/B the worker-thread engine against the single-thread virtual-clock
    engine on the same skewed burst of ``4 * batch`` frames (numpy seed
    0); one ``ServeSpec`` per mode, executed by one shared ``Session``.
    Returns each mode's frames per second of wall time and request
    balance, and the threaded speedup."""
    sess = api.Session(cfg, params=params, device=device)
    rng = np.random.default_rng(0)
    n = 4 * batch
    frames = np.clip(
        rng.uniform(0, 1, (n, *cfg.input_hw, cfg.input_channels))
        * rng.lognormal(-0.5, 1.2, (n, 1, 1, 1)), 0, 1).astype(np.float32)
    walls, balance = {}, {}
    for threaded in (False, True):
        spec = api.ServeSpec(
            backend=backend, num_lanes=lanes, max_batch=batch,
            buckets=(batch,), threaded=threaded, keep_logits=False,
            chunk_timesteps=chunk_timesteps)
        eng = sess.engine(spec)
        eng.warmup()
        for f in frames:
            eng.submit(f, arrival=0.0)
        t0 = time.perf_counter()
        s = eng.run()
        mode = "threaded" if threaded else "1-thread"
        walls[mode] = time.perf_counter() - t0
        balance[mode] = s["request_balance"]
        log.info("%9s: %7.1f frames/s wall (balance=%.3f, lanes=%d)",
                 mode, n / walls[mode], balance[mode], lanes)
    speedup = walls["1-thread"] / walls["threaded"]
    log.info("threaded speedup: %.2fx", speedup)
    return {"frames_per_s": {k: n / v for k, v in walls.items()},
            "request_balance": balance, "speedup": speedup}


def serve_lm_batched(cfg: ArchConfig, *, params=None, prompts=None,
                     batch: int = 4, prompt_len: int = 64, new: int = 32,
                     device=None) -> Dict:
    """Prefill ``batch`` prompts (or ``prompts``), then decode ``new - 1``
    greedy steps (``launch.serve.serve_lm``, seed 0), logging the
    prefill's ms, the decode rate and the first sequence's first 16
    generated ids.  Returns serve_lm's numbers."""
    s = serve_lm(cfg, batch=batch, prompt_len=prompt_len, new=new,
                 device=device, params=params, prompts=prompts)
    log.info("prefill: %dx%d in %.0fms", s["batch"], s["prompt_len"],
             s["prefill_seconds"] * 1e3)
    log.info("decode: %d tokens in %.0fms (%.1f tok/s on %s, %s)",
             s["decode_tokens"], s["decode_seconds"] * 1e3,
             s["decode_tokens_per_s"], s["device"], cfg.name)
    log.info("sample generation (token ids): %s",
             s["tokens"][0, :16].tolist())
    if not np.isfinite(s["logits"]).all():
        raise AssertionError(f"{cfg.name} gave non-finite logits")
    return s


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snn", default="snn-mnist")
    ap.add_argument("--arch", default=None,
                    help="serve a registered LM's reduced config instead "
                         "of an SNN (e.g. gemma3-4b)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--backend", default="hopper", choices=SNN_BACKENDS,
                    help="SNN execution backend (see core.snn_model)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--threaded", action="store_true",
                    help="A/B worker-thread engine lanes vs single thread")
    ap.add_argument("--lanes", type=int, default=2,
                    help="engine lanes (with --threaded)")
    ap.add_argument("--chunk-timesteps", type=int, default=None,
                    help="run T in chunks of this many timesteps "
                         "(bit-identical logits to whole-T dispatch)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    configure_logging("info")
    if args.arch:
        return serve_lm_batched(reduced(get_arch(args.arch)),
                                batch=args.batch, prompt_len=args.prompt_len,
                                new=args.new, device=args.device)
    cfg = get_snn(args.snn)
    if args.threaded:
        return serve_snn_threaded(cfg, backend=args.backend,
                                  batch=args.batch, lanes=args.lanes,
                                  chunk_timesteps=args.chunk_timesteps,
                                  device=args.device)
    return serve_snn_batched(cfg, backend=args.backend, batch=args.batch,
                             chunk_timesteps=args.chunk_timesteps,
                             device=args.device)


if __name__ == "__main__":
    main()
