"""The port's language models (``"family": "lm"``).

A configuration file names the port's registered architecture (``arch``),
gives the published config's keys in its ``model`` block (and the layer
pattern, ``layers``, in the port's kind names), and lists under
``changed`` each setting of the port's config that the benchmark
overrides, with its reason.  ``port_config`` applies those overrides and
checks every key of the ``model`` block against the result.

Weights follow the benchmark's law (``data/lm_weights.py``), written into
the tree the port builds (``transformer.Transformer``) block by block, so
a change to the port's initialisation moves no reading.

``closed_decode``: ``batch`` sequences decoded greedily in a closed loop
through the port's LM path, as ``launch/serve.py:serve_lm`` drives it:
set-up draws ``prompt_len`` token ids a sequence uniformly from the
vocabulary, prefills them into caches of ``cache_len`` positions and
decodes ``warm_steps`` steps; the window runs ``decode_step`` after
``decode_step`` from the end of the prompt, reading each step's tokens on
the host.  A sequence that reaches ``cache_len`` decodes again from the end
of its prompt: the prompt's cache is kept and later positions are written
again.  The check compares the logits of the prefill's last position and
of the window's first ``check_steps`` steps with the plain reference
(``reference/lm.py``), run once over each prompt with its served tokens.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List

import torch

from skybench import harness
from skybench.data.lm_weights import DTYPES, block_weights, blocks, \
    layer_kinds
from skybench.drivers import Driver
from skybench.inputs import sub_seed
from skybench.reference import lm as ref
from skybench.work_lm import decode_work, occupied_experts

__all__ = ["MODES", "ClosedDecode", "model_of", "arch_config",
           "port_config", "fill", "tiny_lm", "narrow"]

# the ``model`` block's keys that every LM has: (the port's config
# section, its field); each layer kind adds its own
# (``lm_keys/<kind>.json``: ``fields``, and ``fixed``, what the port's code
# computes with no setting for it)
KEYS = {
    "num_hidden_layers": (None, "num_layers"),
    "hidden_size": (None, "d_model"),
    "intermediate_size": (None, "d_ff"),
    "vocab_size": (None, "vocab_size"),
    "rms_norm_eps": (None, "norm_eps"),
    "tie_word_embeddings": (None, "tie_embeddings"),
}
KIND_KEYS = Path(__file__).resolve().parent / "lm_keys"


def kind_keys(name: str) -> Dict:
    """``lm_keys/<name>.json`` of a layer kind."""
    path = KIND_KEYS / f"{name}.json"
    if not path.is_file():
        raise ValueError(f"layer kind {name!r}: no {path}")
    return json.loads(path.read_text())


def model_of(cfg) -> Dict:
    """The ``model`` block that describes the port's ``ArchConfig``."""
    pattern = cfg.pattern()
    keys, fixed = dict(KEYS), {}
    for name in sorted({k for layer in pattern for k in layer}):
        spec = kind_keys(name)
        keys.update({k: tuple(v) for k, v in spec["fields"].items()})
        fixed.update(spec["fixed"])
    out = {}
    for key, (section, field) in keys.items():
        part = cfg if section is None else getattr(cfg, section)
        out[key] = getattr(part, field)
    out.update(fixed)
    if cfg.moe is not None:
        out["first_k_dense_replace"] = next(
            (i for i, (_, f) in enumerate(pattern) if f != "ffn_dense"),
            len(pattern))
    out["layers"] = [[r, [list(k) for k in sub]]
                     for r, sub in cfg.stage_list()]
    return out


def _override(cfg, path: str, value):
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(
        cfg, **{head: _override(getattr(cfg, head), rest, value)})


def arch_config(config: Dict):
    """The port's ``ArchConfig`` of ``config["arch"]`` with the file's
    ``changed`` settings, unchecked."""
    from repro_torch.config import get_arch
    cfg = get_arch(config["arch"])
    for path, entry in config.get("changed", {}).items():
        cfg = _override(cfg, path, entry["value"])
    if cfg.frontend != "tokens" or cfg.is_encoder_only:
        raise ValueError(f"{cfg.name}: closed_decode takes a causal "
                         f"token model")
    return cfg


def port_config(config: Dict):
    """``arch_config``, checked key by key against the file's ``model``
    block: a key the port has no setting for, or holds at another value,
    raises."""
    cfg = arch_config(config)
    have = model_of(cfg)
    for key, want in config["model"].items():
        if key not in have:
            raise ValueError(f"{config['arch']}: the port has no setting "
                             f"for {key!r}")
        if have[key] != want:
            raise ValueError(f"{config['arch']}: {key} is {have[key]} in "
                             f"the port, {want} in the file")
    return cfg


def fill(params: torch.nn.Module, model: Dict, seed: int,
         dtype: torch.dtype) -> None:
    """Write the law's weights of ``seed`` into the port's tree, block by
    block on its device; every parameter is written once."""
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    written = set()
    with torch.no_grad():
        for block in blocks(model):
            prefix = "" if isinstance(block, str) else f"layers.{block}."
            for leaf, t in block_weights(model, block, seed, dtype,
                                         device).items():
                name = prefix + leaf
                p = named[name]
                if p.shape != t.shape:
                    raise ValueError(f"{name}: {tuple(p.shape)} in the "
                                     f"port, {tuple(t.shape)} by the law")
                p.copy_(t)
                written.add(name)
    missed = set(named) - written
    if missed:
        raise ValueError(f"the law writes no weight to {sorted(missed)}")


class ClosedDecode(Driver):
    """Greedy decode of ``batch`` sequences in a closed loop."""

    SMALL_MIX = dict(batch=2, prompt_len=8, cache_len=16, warm_steps=1,
                     check_steps=3)

    def setup(self) -> None:
        from repro_torch.models import transformer
        m, cfg = self.mix, self.ctx.cfg
        batch, prompt, size = (int(m["batch"]), int(m["prompt_len"]),
                               int(m["cache_len"]))
        self.dtype = DTYPES[self.ctx.config["dtype"]]
        gen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.ctx.seed, 1))
        self.prompts = torch.randint(
            0, self.model["vocab_size"], (batch, prompt), generator=gen,
            device=self.device, dtype=torch.int32)
        self.params = transformer.Transformer(cfg, dtype=self.dtype,
                                              device=self.device)
        fill(self.params, self.model, self.ctx.seed, self.dtype)
        with torch.inference_mode():
            logits, self.caches = transformer.prefill(
                self.params, cfg, tokens=self.prompts, remat=False,
                max_len=size, cache_dtype=self.dtype)
            self.first = logits[:, -1:].argmax(-1).to(torch.int32)
            self.prefill_logits = logits[:, -1].float()
            tok = self.first
            for i in range(int(m["warm_steps"])):
                logits, self.caches = transformer.decode_step(
                    self.params, self.caches, cfg, token=tok,
                    pos=prompt + i)
                tok = logits[:, -1:].argmax(-1).to(torch.int32)
                tok.cpu()
        self.sync()

    def window(self, seconds: float) -> Dict[str, float]:
        from repro_torch.models import transformer
        m, cfg = self.mix, self.ctx.cfg
        batch, prompt, size = (int(m["batch"]), int(m["prompt_len"]),
                               int(m["cache_len"]))
        keep = int(m["check_steps"])
        self.served: List[torch.Tensor] = []      # host tokens, kept steps
        self.step_logits: List[torch.Tensor] = []
        positions, traced = [], []
        tok, pos = self.first, prompt
        t0 = time.perf_counter()
        with torch.inference_mode():
            while time.perf_counter() - t0 < seconds:
                self.trace_due(t0, seconds)
                with self.span("decode_step"):
                    logits, self.caches = transformer.decode_step(
                        self.params, self.caches, cfg, token=tok, pos=pos)
                    tok = logits[:, -1:].argmax(-1).to(torch.int32)
                    host = tok.cpu()
                if len(self.served) < keep:
                    self.served.append(host)
                    self.step_logits.append(logits[:, -1].clone())
                positions.append(pos)
                if self.trace.active:
                    traced.append(pos)
                pos += 1
                if pos == size:             # from the end of the prompt
                    tok, pos = self.first, prompt
        t1 = time.perf_counter()
        self.trace.stop()
        steps = len(positions)
        self.readings.update(window_s=t1 - t0, steps_window=steps,
                             attempted=batch * steps, positions=positions,
                             steps_traced=len(traced),
                             traced_positions=traced)
        return {"decode_tok_s": batch * steps / (t1 - t0)}

    def release(self) -> None:
        self.params = self.caches = None
        super().release()

    def _reference(self, control: bool) -> ref.RefLogits:
        """Over each prompt and its served tokens but the last."""
        ref.exact_float32()
        served = self._served()[:, :-1].to(self.device, torch.int32)
        tokens = torch.cat([self.prompts, served], 1)

        def weights(block):
            return block_weights(self.model, block, self.ctx.seed,
                                 self.dtype, self.device)

        kinds = [tuple(harness.load_kind(k) for k in layer)
                 for layer in layer_kinds(self.model)]
        return ref.forward(self.model, weights, tokens,
                           self.prompts.shape[1] - 1, kinds=kinds,
                           control=control)

    def _served(self) -> torch.Tensor:
        """(B, n + 1): the prefill's token and each kept step's."""
        return torch.cat([self.first.cpu()] + self.served, 1)

    @staticmethod
    def _numbers(logits: torch.Tensor, served: torch.Tensor,
                 want: torch.Tensor) -> Dict[str, float]:
        """``mean_gap``: mean |logit gap| over the reference's mean
        |logit|.  ``token_mean_gap``: the mean, over served tokens, of the
        gap by which a served token's reference logit lies below the
        reference's best at its position, over the reference logits'
        rms."""
        want = want.double()
        gap = (logits.to(want) - want).abs().sum() / want.abs().sum()
        got = want.gather(-1, served.to(want.device).long()[..., None])
        below = (want.max(-1).values - got[..., 0]) \
            / want.pow(2).mean().sqrt()
        return {"mean_gap": float(gap),
                "token_mean_gap": float(below.mean())}

    def check(self) -> Dict[str, float]:
        self.ref_out = self._reference(control=False)
        self._work(self.ref_out.routes)
        logits = torch.stack([self.prefill_logits]
                             + [s.float() for s in self.step_logits], 1)
        return self._numbers(logits, self._served(), self.ref_out.logits)

    def controlled(self) -> Dict[str, float]:
        """The reference in float8 products in the program's place: at
        each position of the same prompts and served tokens, the token it
        puts first."""
        if not hasattr(self, "ref_out"):
            self.ref_out = self._reference(control=False)
        ctl = self._reference(control=True).logits
        return self._numbers(ctl, ctl.argmax(-1), self.ref_out.logits)

    def _work(self, routes) -> None:
        r = self.readings
        batch, prompt = int(self.mix["batch"]), int(self.mix["prompt_len"])
        occ = occupied_experts(routes, prompt, len(self.served))
        wb = torch.finfo(self.dtype).bits / 8
        r["occupied_experts"] = occ
        r["work_window"] = decode_work(self.model, r["positions"], batch,
                                       occ, wb)
        r["work_traced"] = decode_work(self.model, r["traced_positions"],
                                       batch, occ, wb)


MODES = {"closed_decode": ClosedDecode}


TINY_LAYERS = 8     # deep enough that bfloat16 and float8 part as at depth


def tiny_lm(conf):
    """The port's ``reduced`` config of an LM file's ``arch`` with its last
    stage repeated to ``TINY_LAYERS`` layers, its MoE still at capacity
    factor E / k (no choice drops), and the ``model`` block of what the
    port computes (``model_of``: its own gates among them)."""
    from repro_torch.config import get_arch, reduced
    cfg = reduced(get_arch(conf["arch"]))
    *lead, (repeats, sub) = cfg.stage_list()
    first = sum(r * len(s) for r, s in lead)
    repeats = max(repeats, (TINY_LAYERS - first) // len(sub))
    cfg = dataclasses.replace(cfg, stages=(*lead, (repeats, sub)),
                              num_layers=first + repeats * len(sub))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg, model_of(cfg)


def narrow(name: str, config: Dict):
    """(the port's config, the ``model`` override) of the file ``name``
    cut for a run on the CPU: ``tiny_lm``."""
    return tiny_lm(config)
